"""K5: a chain of binary conv and OR-pool stages in one launch (DESIGN.md §9).

Port of ``repro.kernels.chain_conv.chain_conv``; the CUDA kernel is
``csrc/chain_conv.cu``.  The paper's layer integration (§V-C) carried
across layers: a region of conv / pool stages runs in one launch, and
every interior stage output lives in an on-chip arena at the offset the
memory planner assigned (:func:`repro_torch.runtime.memory.vmem_plan`).
Only the chain's entry and exit touch device memory.

On the card one thread-block cluster of C blocks (C = 16, 8 or 4:
:func:`cluster_size`) runs each (image block, final tile).  Every block
holds a full copy of the arena; :func:`chain_shares` splits each stage's
valid positions among the C ranks (by output rows, or by output words
when the stage has fewer rows than ranks), and before each stage a rank
copies from its neighbours' shared memory the words its share reads
(:func:`chain_gather` names them).  Masked positions are stored as the
0-word without being computed.

Tiling couples the stages through halo growth: to emit a
``(block_h, block_w)`` tile of the final stage, stage k must produce a
tile grown backwards through every later window and stride.  Tile
origins are affine in the grid index (``origin = gi*step - off``), so
border tiles run past a stage's valid extent; those positions are masked
to the 0-word before the arena store.  The 0-word is 32 channels of -1,
which is both the conv padding and the OR-pool identity (DESIGN.md
§3.2), so the masked store *is* the next stage's padding.  The default
tile is the whole map with ``block_n = 1``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import binary_ops, packing
from repro_torch.core.packing import WORD_BITS, num_words
from repro_torch.kernels import build

# The CUDA kernel's stage-descriptor array (csrc/chain_conv.cu kMaxStages)
# and its largest cluster (kMaxCluster); the cluster sizes tried, largest
# first (16 needs the non-portable cluster size).
MAX_STAGES = 16
MAX_CLUSTER = 16
CLUSTER_SIZES = (16, 8, 4)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One static chain stage.  ``kind`` is ``"conv"`` (fused binary conv +
    integer threshold + pack; ``kernel``/``stride``/``pad_*`` are the conv
    geometry, ``channels`` the valid output channels) or ``"pool"``
    (windowed OR over packed words; ``kernel`` is the pool window)."""
    kind: str
    kernel: int
    stride: int
    pad_lo: int = 0
    pad_hi: int = 0
    channels: int = 0
    first: bool = False

    def out_size(self, size: int) -> int:
        return (size + self.pad_lo + self.pad_hi - self.kernel) \
            // self.stride + 1


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """Host-side tile geometry for one (chain, tile-shape) pairing."""
    out_tile: tuple[tuple[int, int], ...]   # per-stage output tile (th, tw)
    out_step: tuple[tuple[int, int], ...]   # tile-origin step per grid inc
    out_off: tuple[tuple[int, int], ...]    # tile-origin static offset
    valid_hw: tuple[tuple[int, int], ...]   # per-stage valid output extent
    entry_tile: tuple[int, int]
    entry_step: tuple[int, int]
    entry_off: tuple[int, int]              # == top/left pre-pad of entry
    final_hw: tuple[int, int]


def chain_geometry(stages: tuple[StageSpec, ...], h: int, w: int,
                   block_h: int | None, block_w: int | None) -> _Geometry:
    """Backward halo propagation: from the final (block_h, block_w) output
    tile, grow each stage's required tile through its window and stride.
    Tile origins are affine in the grid index: ``origin = gi*step - off``.
    """
    hs, ws = [h], [w]
    for st in stages:
        hs.append(st.out_size(hs[-1]))
        ws.append(st.out_size(ws[-1]))
    fh, fw = hs[-1], ws[-1]
    th, tw = min(block_h or fh, fh), min(block_w or fw, fw)

    out_tile, out_step, out_off, valid = [], [], [], []
    mh, oh, mw, ow = th, 0, tw, 0
    for k in reversed(range(len(stages))):
        st = stages[k]
        out_tile.append((th, tw))
        out_step.append((mh, mw))
        out_off.append((oh, ow))
        valid.append((hs[k + 1], ws[k + 1]))
        th = (th - 1) * st.stride + st.kernel
        tw = (tw - 1) * st.stride + st.kernel
        mh, oh = mh * st.stride, oh * st.stride + st.pad_lo
        mw, ow = mw * st.stride, ow * st.stride + st.pad_lo
    return _Geometry(
        out_tile=tuple(reversed(out_tile)),
        out_step=tuple(reversed(out_step)),
        out_off=tuple(reversed(out_off)),
        valid_hw=tuple(reversed(valid)),
        entry_tile=(th, tw), entry_step=(mh, mw), entry_off=(oh, ow),
        final_hw=(fh, fw))


@dataclasses.dataclass(frozen=True)
class StageShare:
    """How the ranks of a cluster split one stage's valid positions.
    ``rows`` = [lo, hi) are the output-tile rows valid in some tile of the
    grid.  With ``by_rows`` rank r computes rows ``bounds[r]`` (all
    words), else output words ``bounds[r]`` of every row in ``rows``."""
    by_rows: bool
    rows: tuple[int, int]
    bounds: tuple[tuple[int, int], ...]


def chain_shares(geo: _Geometry, cws, cluster: int
                 ) -> tuple[StageShare, ...]:
    """Per stage, the split of its valid positions over ``cluster`` ranks:
    contiguous output rows when the stage has at least ``cluster``
    computed rows, else contiguous output channel words; shares differ by
    at most one row or word."""
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"chain_shares: cluster {cluster} outside 1.."
                         f"{MAX_CLUSTER}")
    gh = -(-geo.final_hw[0] // geo.out_tile[-1][0])
    shares = []
    for k, (th, _) in enumerate(geo.out_tile):
        step, off, valid = (geo.out_step[k][0], geo.out_off[k][0],
                            geo.valid_hw[k][0])
        # Tile gi's valid rows are [off - gi*step, valid + off - gi*step).
        lo, hi = max(0, off - (gh - 1) * step), min(th, valid + off)
        n = hi - lo
        by_rows = n >= cluster
        base, span = (lo, n) if by_rows else (0, cws[k + 1])
        shares.append(StageShare(by_rows, (lo, hi), tuple(
            (base + span * r // cluster, base + span * (r + 1) // cluster)
            for r in range(cluster))))
    return tuple(shares)


def chain_gather(stages: tuple[StageSpec, ...], geo: _Geometry, cws,
                 shares: tuple[StageShare, ...], k: int, rank: int
                 ) -> list[tuple[int, tuple[int, int], tuple[int, int]]]:
    """What ``rank`` copies before stage k (k >= 1): blocks ``(owner, rows,
    words)`` of stage k-1's output tile (all its columns) that its share of
    stage k reads and ``owner`` computed.  The kernel copies the same
    blocks, further cut to the positions valid in its tile (the masked
    ones it holds as 0-words already)."""
    st, sh, prev = stages[k], shares[k], shares[k - 1]
    lo, hi = sh.bounds[rank] if sh.by_rows else sh.rows
    w_lo, w_hi = sh.bounds[rank] if not sh.by_rows else (0, cws[k + 1])
    if lo >= hi or w_lo >= w_hi:
        return []
    r0 = lo * st.stride
    r1 = min(geo.out_tile[k - 1][0], (hi - 1) * st.stride + st.kernel)
    g0, g1 = ((0, cws[k]) if st.kind == "conv" or sh.by_rows
              else (w_lo, w_hi))
    blocks = []
    for o in range(len(sh.bounds)):
        if o == rank:
            continue
        o_rows = prev.bounds[o] if prev.by_rows else prev.rows
        o_words = (0, cws[k]) if prev.by_rows else prev.bounds[o]
        rows = (max(r0, o_rows[0]), min(r1, o_rows[1]))
        words = (max(g0, o_words[0]), min(g1, o_words[1]))
        if rows[0] < rows[1] and words[0] < words[1]:
            blocks.append((o, rows, words))
    return blocks


def chain_word_counts(stages: tuple[StageSpec, ...], cw_in: int
                      ) -> list[int]:
    """Packed word count entering each stage (index 0 = chain input) and
    leaving the last (index len(stages))."""
    cws = [cw_in]
    for st in stages:
        cws.append(num_words(st.channels) if st.kind == "conv" else cws[-1])
    return cws


@dataclasses.dataclass(frozen=True)
class ChainOperands:
    """Per conv stage, in chain order, the operands in the kernel's layout
    (built once per chain by :func:`chain_operands`):

    * ``w_t``: (K, O_pad) int32, the packed filters transposed, so the 32
      lanes of a warp read 32 consecutive words; pad channels are 0;
    * ``ww``: (K,) int32 word weights, or None (all ones);
    * ``t``: (O_pad,) int32 thresholds, -1 on pad channels;
    * ``s``: (O_pad,) int32 sign flips, 0 on pad channels,

    with K = kernel²·Cw_in and O_pad = 32·ceil(channels/32), so pad
    channels give 0-bits, as ``pack_bits`` does.
    """
    w_t: tuple[torch.Tensor, ...]
    ww: tuple[torch.Tensor | None, ...]
    t: tuple[torch.Tensor, ...]
    s: tuple[torch.Tensor, ...]


def chain_operands(stages: tuple[StageSpec, ...], stage_arrays: tuple
                   ) -> ChainOperands:
    """Pad and transpose the reference's per-conv-stage
    ``(w_packed (O, K), word_weights | None, threshold (O,), sign_flip
    (O,))`` tuples into :class:`ChainOperands`."""
    w_t, wws, ts, ss = [], [], [], []
    convs = [st for st in stages if st.kind == "conv"]
    if len(stage_arrays) != 4 * len(convs):
        raise ValueError(f"chain_operands: {len(stage_arrays)} arrays for "
                         f"{len(convs)} conv stages, want 4 each")
    for i, st in enumerate(convs):
        w_p, ww, t, s = stage_arrays[4 * i:4 * i + 4]
        o_pad = num_words(st.channels) * WORD_BITS - w_p.shape[0]
        w_t.append(F.pad(w_p, (0, 0, 0, o_pad)).t().contiguous())
        wws.append(None if ww is None else ww.to(torch.int32).contiguous())
        ts.append(F.pad(t.to(torch.int32), (0, o_pad), value=-1))
        ss.append(F.pad(s.to(torch.int32), (0, o_pad)))
    return ChainOperands(tuple(w_t), tuple(wws), tuple(ts), tuple(ss))


def _dense_arena(geo: _Geometry, cws, bn: int
                 ) -> tuple[tuple[int, ...], int]:
    """No-reuse arena layout (int32 words), for calls without a plan."""
    offs, total = [], 0
    for k, (th, tw) in enumerate(geo.out_tile[:-1]):
        offs.append(total)
        total += bn * th * tw * cws[k + 1]
    return tuple(offs), total


def _conv_stage(x, st: StageSpec, w_t, ww, t, s, *, out_h: int,
                out_w: int) -> torch.Tensor:
    """(bn, ih, iw, cw) tile -> (bn, out_h, out_w, O_pad/32) words: the
    KH x KW taps as strided slices of the tile (no padding: the tile
    already holds it), weighted xor-popcount counts, threshold, pack."""
    bn, _, _, cw = x.shape
    w = w_t.t()                                   # (O_pad, K) view
    cnt = torch.zeros((bn * out_h * out_w, w.shape[0]), dtype=torch.int32,
                      device=x.device)
    for di in range(st.kernel):
        for dj in range(st.kernel):
            k0 = (di * st.kernel + dj) * cw
            tap = x[:, di:di + (out_h - 1) * st.stride + 1:st.stride,
                    dj:dj + (out_w - 1) * st.stride + 1:st.stride, :]
            cnt += binary_ops.packed_matmul_counts(
                tap.reshape(-1, cw), w[:, k0:k0 + cw],
                None if ww is None else ww[k0:k0 + cw])
    bits = (cnt <= t[None, :]) ^ (s[None, :] != 0)
    return packing.pack_bits(bits, axis=-1).reshape(bn, out_h, out_w, -1)


def _pool_stage(x, st: StageSpec, *, out_h: int, out_w: int
                ) -> torch.Tensor:
    """Windowed bitwise OR over the tile (max-pool on packed words)."""
    out = None
    for i in range(st.kernel):
        for j in range(st.kernel):
            v = x[:, i:i + (out_h - 1) * st.stride + 1:st.stride,
                  j:j + (out_w - 1) * st.stride + 1:st.stride, :]
            out = v if out is None else (out | v)
    return out


def _mask_invalid(y, hi: int, wi: int, step, off, valid) -> torch.Tensor:
    """Zero the tile positions outside the stage's valid output extent."""
    rows = hi * step[0] - off[0] + torch.arange(y.shape[1], device=y.device)
    cols = wi * step[1] - off[1] + torch.arange(y.shape[2], device=y.device)
    ok = (((rows >= 0) & (rows < valid[0]))[:, None]
          & ((cols >= 0) & (cols < valid[1]))[None, :])
    return torch.where(ok[None, :, :, None], y, torch.zeros_like(y))


def chain_conv_plain(x: torch.Tensor, stages: tuple[StageSpec, ...],
                     ops: ChainOperands, *, block_h: int | None = None,
                     block_w: int | None = None, block_n: int = 1,
                     arena_offsets: tuple[int, ...] | None = None,
                     arena_words: int | None = None) -> torch.Tensor:
    """The plain PyTorch version, walked as the reference's kernel walks
    it: the grid ``(gn, gh, gw)``, the entry pre-padded with 0-words, the
    halo origins ``gi*step - off``, interior masking to 0-words, and each
    interior stage stored to and reloaded from a flat arena at the
    planner's offsets — so a geometry or plan fault shows here too."""
    n, h, w_in, cw0 = x.shape
    geo = chain_geometry(stages, h, w_in, block_h, block_w)
    fh, fw = geo.final_hw
    bh, bw = geo.out_tile[-1]
    bn = max(1, min(block_n, n))
    cws = chain_word_counts(stages, cw0)
    if arena_offsets is None:
        arena_offsets, arena_words = _dense_arena(geo, cws, bn)

    gn, gh, gw = -(-n // bn), -(-fh // bh), -(-fw // bw)
    ih, iw = geo.entry_tile
    rstep, cstep = geo.entry_step
    top, left = geo.entry_off
    need_h = (gh - 1) * rstep + ih
    need_w = (gw - 1) * cstep + iw
    xp = F.pad(x, (0, 0, left, max(0, need_w - w_in - left),
                   top, max(0, need_h - h - top), 0, gn * bn - n))
    out = torch.zeros((gn * bn, gh * bh, gw * bw, cws[-1]),
                      dtype=torch.int32, device=x.device)
    arena = torch.zeros((max(arena_words, 1),), dtype=torch.int32,
                        device=x.device)
    last = len(stages) - 1
    for ni in range(gn):
        for hi in range(gh):
            for wi in range(gw):
                t = xp[ni * bn:(ni + 1) * bn, hi * rstep:hi * rstep + ih,
                       wi * cstep:wi * cstep + iw]
                ci = 0
                for k, st in enumerate(stages):
                    th, tw = geo.out_tile[k]
                    if st.kind == "conv":
                        y = _conv_stage(t, st, ops.w_t[ci], ops.ww[ci],
                                        ops.t[ci], ops.s[ci], out_h=th,
                                        out_w=tw)
                        ci += 1
                    else:
                        y = _pool_stage(t, st, out_h=th, out_w=tw)
                    if k == last:
                        out[ni * bn:(ni + 1) * bn, hi * bh:(hi + 1) * bh,
                            wi * bw:(wi + 1) * bw] = y
                        continue
                    y = _mask_invalid(y, hi, wi, geo.out_step[k],
                                      geo.out_off[k], geo.valid_hw[k])
                    off = arena_offsets[k]
                    arena[off:off + y.numel()] = y.reshape(-1)
                    t = arena[off:off + y.numel()].reshape(y.shape)
    return out[:n, :fh, :fw].contiguous()


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """The card's opt-in shared memory per block
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``), in bytes."""
    return build.library().phonebit_smem_optin(device_index)


@functools.lru_cache(maxsize=None)
def max_clusters(arena_words: int, cluster: int) -> int:
    """Clusters of ``cluster`` blocks, each with the arena in shared
    memory, that the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0: none can be scheduled)."""
    n = ctypes.c_int()
    build.check(build.library().chain_conv_max_clusters(
        arena_words, cluster, ctypes.addressof(n)), "chain_conv")
    return n.value


@functools.lru_cache(maxsize=None)
def cluster_size(arena_words: int, clusters: int = 1) -> int:
    """The cluster size the kernel runs a grid of ``clusters`` clusters in:
    of the ``CLUSTER_SIZES`` the card can schedule with this arena, the
    one with the fewest waves (``ceil(clusters / held at once)``) per
    block of the cluster, each rank's work falling as 1/C; on a tie the
    one with fewer waves.  So a grid that fits at once takes the largest
    size, and one that would leave a second wave of large clusters takes
    a smaller size that fits.  Raises when none can be scheduled."""
    best = None
    for c in CLUSTER_SIZES:
        held = max_clusters(arena_words, c)
        if held < 1:
            continue
        waves = -(-clusters // held)
        key = (waves * MAX_CLUSTER // c, waves)     # c divides MAX_CLUSTER
        if best is None or key < best[0]:
            best = (key, c)
    if best is None:
        raise RuntimeError(f"chain_conv: no cluster of {CLUSTER_SIZES} "
                           f"blocks with a {4 * arena_words} B arena can be "
                           f"scheduled")
    return best[1]


def kernel_info() -> dict[str, int]:
    """The CUDA kernel's registers a thread and threads a block
    (``cudaFuncGetAttributes``)."""
    vals = [ctypes.c_int() for _ in range(2)]
    build.check(build.library().chain_conv_info(
        *(ctypes.addressof(v) for v in vals)), "chain_conv_info")
    return dict(zip(("registers", "threads"), (v.value for v in vals)))


def _descriptors(stages, geo: _Geometry, cws, ops: ChainOperands,
                 arena_offsets, shares, dev) -> np.ndarray:
    """The kernel's per-stage descriptor rows (int64; csrc/chain_conv.cu
    ``Stage``), validating each conv stage's operands on the way."""
    rows, ci = [], 0
    for k, st in enumerate(stages):
        in_h, in_w = geo.entry_tile if k == 0 else geo.out_tile[k - 1]
        out_h, out_w = geo.out_tile[k]
        ptrs = [0, 0, 0, 0]
        if st.kind == "conv":
            kk, o_pad = st.kernel * st.kernel * cws[k], cws[k + 1] * 32
            w_t, ww, t, s = (ops.w_t[ci], ops.ww[ci], ops.t[ci], ops.s[ci])
            ci += 1
            build.require(w_t, f"stage {k} w_t", torch.int32, 2, dev)
            build.require(t, f"stage {k} t", torch.int32, 1, dev)
            build.require(s, f"stage {k} s", torch.int32, 1, dev)
            if tuple(w_t.shape) != (kk, o_pad) or t.shape[0] != o_pad \
                    or s.shape[0] != o_pad:
                raise ValueError(f"chain_conv: stage {k} operands "
                                 f"{tuple(w_t.shape)}, want ({kk}, {o_pad})")
            if ww is not None:
                build.require(ww, f"stage {k} ww", torch.int32, 1, dev)
                if ww.shape[0] != kk:
                    raise ValueError(f"chain_conv: stage {k} word weights "
                                     f"{ww.shape[0]}, want {kk}")
            ptrs = [w_t.data_ptr(), 0 if ww is None else ww.data_ptr(),
                    t.data_ptr(), s.data_ptr()]
        elif st.kind != "pool":
            raise ValueError(f"chain_conv: unknown stage kind {st.kind!r}")
        sh = shares[k]
        bounds = list(sh.bounds) + [(0, 0)] * (MAX_CLUSTER - len(sh.bounds))
        rows.append([0 if st.kind == "conv" else 1, st.kernel, st.stride,
                     in_h, in_w, cws[k], out_h, out_w, cws[k + 1],
                     *geo.out_step[k], *geo.out_off[k], *geo.valid_hw[k],
                     -1 if k == 0 else arena_offsets[k - 1],
                     -1 if k == len(stages) - 1 else arena_offsets[k],
                     *ptrs, int(sh.by_rows), *sh.rows,
                     *(v for b in bounds for v in b)])
    return np.ascontiguousarray(rows, dtype=np.int64)


def chain_conv(x: torch.Tensor, stages: tuple[StageSpec, ...],
               ops: ChainOperands, *, block_h: int | None = None,
               block_w: int | None = None, block_n: int = 1,
               arena_offsets: tuple[int, ...] | None = None,
               arena_words: int | None = None,
               cluster: int | None = None) -> torch.Tensor:
    """Run a static conv/pool chain in one launch.

    x: (N, H, W, Cw) int32 packed words (bit-plane words for a
    first-layer entry); ``ops`` from :func:`chain_operands`;
    ``arena_offsets`` / ``arena_words``: int32-element offsets per
    interior stage output and the arena's extent, normally from the
    planner (:meth:`repro_torch.runtime.regions.Chain.arena`); a dense
    no-reuse layout when omitted.  Returns (N, FH, FW, ceil(O_last/32))
    int32 (pool-only chains keep Cw).

    Launches the CUDA kernel for a CUDA tensor, in clusters of
    ``cluster`` blocks (default :func:`cluster_size` for the grid), and
    raises if the arena exceeds the card's shared memory per block or no
    such cluster can be scheduled; a CPU tensor takes the plain version.
    """
    if x.device.type == "cpu":
        return chain_conv_plain(x, stages, ops, block_h=block_h,
                                block_w=block_w, block_n=block_n,
                                arena_offsets=arena_offsets,
                                arena_words=arena_words)
    if x.device.type != "cuda":
        raise ValueError(f"chain_conv: unsupported device {x.device}")
    dev = x.device
    build.require(x, "x", torch.int32, 4, dev)
    if not 1 <= len(stages) <= MAX_STAGES:
        raise ValueError(f"chain_conv: {len(stages)} stages, the kernel "
                         f"takes 1 to {MAX_STAGES}")
    n, h, w_in, cw0 = x.shape
    geo = chain_geometry(stages, h, w_in, block_h, block_w)
    fh, fw = geo.final_hw
    bh, bw = geo.out_tile[-1]
    bn = max(1, min(block_n, n))
    cws = chain_word_counts(stages, cw0)
    if arena_offsets is None:
        arena_offsets, arena_words = _dense_arena(geo, cws, bn)
    limit = smem_optin(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    if 4 * arena_words > limit:
        raise ValueError(f"chain_conv: arena of {4 * arena_words} B exceeds "
                         f"the card's {limit} B of shared memory per block")
    gn, gh, gw = -(-n // bn), -(-fh // bh), -(-fw // bw)
    if cluster is None:
        cluster = cluster_size(arena_words, gn * gh * gw)
    elif cluster not in CLUSTER_SIZES \
            or max_clusters(arena_words, cluster) < 1:
        raise ValueError(f"chain_conv: a cluster of {cluster} blocks with "
                         f"a {4 * arena_words} B arena cannot be scheduled")
    desc = _descriptors(stages, geo, cws, ops, arena_offsets,
                        chain_shares(geo, cws, cluster), dev)
    out = torch.empty((n, fh, fw, cws[-1]), dtype=torch.int32, device=dev)
    lib = build.library()
    chain_conv.launches += 1
    build.check(lib.launch_chain_conv(
        x.data_ptr(), out.data_ptr(), desc.ctypes.data, len(stages), n, h,
        w_in, cw0, bn, gn, gh, gw, *geo.entry_step, *geo.entry_off,
        arena_words, cluster, build.stream_ptr(dev)), "chain_conv")
    return out


chain_conv.launches = 0
