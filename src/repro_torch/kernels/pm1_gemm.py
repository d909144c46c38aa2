"""Planner of the +-1 tensor-core mainloop that K6 and K2 share.

``csrc/pm1_gemm.cuh`` computes ``dot[x, y]`` over all ``32·W`` bits of two
sets of packed rows on the int8 tensor cores; K6 (``mxu_pm1_matmul``)
takes ``dot - pad_bits``, K2 (``fused_matmul_bn_binarize`` without word
weights) thresholds ``(32·W - dot) / 2`` and packs.  :func:`plan_pm1`
picks, for one ``(M, N, W)``:

* the orientation and tile (:data:`TILES`): up to :data:`SWAP_MAX_M` rows
  (the dense layers at small batch) the operands are swapped, so the
  filters fill the mma's 16-row side and the batch rows its 8-column
  side: 32 filters by 8 rows up to 8 rows, 64 by 16 up to 16 (both on
  ``mma.sync``); more rows take the 64 x 64 tile of one warpgroup on
  ``wgmma``, the filters' +-1 bytes expanded into shared memory;
* the cluster split: the word axis cut over ``C`` blocks of a
  thread-block cluster (``C`` a power of two up to :data:`MAX_CLUSTER`,
  each slice at least one unit of :func:`slice_bounds`), their partial
  dots summed by the leader through distributed shared memory.  Swapped,
  ``C`` is the smallest split whose grid covers every SM; unswapped, the
  largest that leaves every block an SM of its own (1 when the tiles
  alone fill the card).

Every plan runs a ring of :data:`STAGES` stages.  The tiles fit the 48 KB
of static shared memory a block, so the plan reads only the SM count from
the card.  Cached: a serving shape plans once.  The rules follow
``tools/pm1_sweep.py``, which times every variant tried (the tiles above
and eight more, ring depths 3 and 4, splits up to 8; built from
``tools/pm1_variants.cu``, not part of the kernel library) beside the
plan, on the H100 (PERF.md): the ``wgmma`` tile beat the ``mma.sync``
ones at conv2 by 27–33% and tied them at conv3–conv5; every split lost
at the batch-8 convs, which the rule leaves unsplit; at the buckets below
8 the rule's split took conv4/conv5 12–29% faster and conv2 at batch 1
11%, and lost 3–5% at conv3; clusters past 2 lost at every dense shape
timed (N 4,096, where 2 already cover the card), and 3 stages were ahead
of 4.
"""

from __future__ import annotations

import dataclasses
import functools
import math

SMS = 132                 # the H100's streaming multiprocessors
SWAP_MAX_M = 16
MAX_CLUSTER = 4
STAGES = 3                # the ring depth (csrc/pm1_gemm.cuh kStages)


@dataclasses.dataclass(frozen=True)
class Tile:
    """A block of ``wm x wn`` warps, each ``mt`` m16 tiles of X by ``nt``
    n8 tiles of Y, ``kw`` words a stage; ``swap``: X is the filters;
    ``wgmma``: one warpgroup's ``wgmma`` with Y's +-1 bytes in shared
    memory."""
    swap: bool
    mt: int
    nt: int
    wm: int
    wn: int
    kw: int
    wgmma: bool = False

    @property
    def bx(self) -> int:
        return 16 * self.mt * self.wm

    @property
    def by(self) -> int:
        return 8 * self.nt * self.wn


# The launcher's numbering (csrc/pm1_gemm.cuh launch_tile).
TILES = (Tile(True, 1, 1, 2, 1, 16),     # 32 filters x 8 batch rows
         Tile(True, 1, 2, 4, 1, 16),     # 64 filters x 16 batch rows
         Tile(False, 1, 8, 4, 1, 8, wgmma=True))    # 64 x 64, wgmma
SWAP_8, SWAP_16, WGMMA_TILE = range(3)


@dataclasses.dataclass(frozen=True)
class Plan:
    tile: int
    cluster: int

    @property
    def swap(self) -> bool:
        return TILES[self.tile].swap

    def grid(self, m: int, n: int) -> tuple[int, int]:
        """The launch grid: (tiles of X x cluster, tiles of Y)."""
        t = TILES[self.tile]
        rows_x, rows_y = (n, m) if t.swap else (m, n)
        return (math.ceil(rows_x / t.bx) * self.cluster,
                math.ceil(rows_y / t.by))


def granule(w: int) -> int:
    """Words a slice is cut in: 4 where W is a multiple of 4 (the 16-byte
    copies stay aligned), else 1."""
    return 4 if w % 4 == 0 else 1


def slice_bounds(w: int, cluster: int) -> list[tuple[int, int]]:
    """Word range ``[begin, end)`` of each rank of a cluster: near-equal
    slices in units of :func:`granule` words (``word_slice`` in the
    kernel)."""
    g = granule(w)
    units = w // g
    return [(r * units // cluster * g, (r + 1) * units // cluster * g)
            for r in range(cluster)]


@functools.lru_cache(maxsize=None)
def plan_pm1(m: int, n: int, w: int, sms: int = SMS) -> Plan:
    """The tile and cluster split of one ``(M, N, W)`` product (module
    docstring)."""
    splits = [c for c in (1, 2, 4)
              if c <= min(w // granule(w), MAX_CLUSTER)]
    if m > SWAP_MAX_M:
        t = TILES[WGMMA_TILE]
        tiles = math.ceil(m / t.bx) * math.ceil(n / t.by)
        return Plan(WGMMA_TILE, max(c for c in splits
                                    if c == 1 or tiles * c <= sms))
    tile = SWAP_8 if m <= 8 else SWAP_16
    t = TILES[tile]
    tiles = math.ceil(n / t.bx) * math.ceil(m / t.by)
    return Plan(tile, next((c for c in splits if tiles * c >= sms),
                           splits[-1]))
