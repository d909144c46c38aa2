"""Binary matmul counts and dots on packed words (paper Eqn 1).

Counterpart of ``repro.core.binary_ops``.  For two packed vectors of
``k_valid`` meaningful bits, ``dot = k_valid - 2 * cnt`` with
``cnt = popcount(a ^ b)``.  Two count algorithms:

* ``"xor"`` — xor + popcount on the packed words (the paper's Eqn 1).
  The plain path broadcasts a (rows, N, words) xor cube, so it walks the
  rows and the word axis in chunks to stay inside memory at full width
  (unchunked, AlexNet conv1 at batch 8 would be ~9 GB).
* ``"pm1"`` — unpack both operands to +-1 float32 and take a real matmul:
  ``cnt = (total_bits - dot) / 2``.  Pad bits agree in both operands, add
  +1 each to the dot and 0 to the count, and ``total_bits`` absorbs them.
  A float32 sum of +-1 terms is exact up to 2^24 terms, and only in full
  float32: see :func:`full_float32`.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core import packing

# Elements of one broadcast (rows, N, words) chunk: 2^24 int32 = 64 MiB,
# a few times that with the popcount temporaries.
CHUNK_ELEMS = 1 << 24
# Words per float32 +-1 product: 2^19 words = 2^24 terms, the most whose
# integer sum float32 holds exactly.
PM1_EXACT_WORDS = 1 << 19


@contextlib.contextmanager
def full_float32():
    """Run float32 matmuls and convolutions in full float32 inside the
    block.  On the card PyTorch may take them in TF32 (cuDNN convolutions
    do by default), which keeps ~10 mantissa bits: a +-1 product or a
    float oracle would no longer be exact."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def pm1_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, N) int32 +-1 dots over all ``32·W`` bits of packed ``a (M, W)``
    and ``b (N, W)``, pad bits included (they unpack to -1 in both and add
    +1 each).  Float32 matmuls over slabs of at most
    :data:`PM1_EXACT_WORDS` words, each exact, summed in int32; rows go
    in chunks of ``CHUNK_ELEMS`` unpacked values."""
    m, w = a.shape
    n = b.shape[0]
    out = torch.zeros((m, n), dtype=torch.int32, device=a.device)
    wc = min(w, PM1_EXACT_WORDS)
    with full_float32():
        for w0 in range(0, w, wc):
            bits = packing.WORD_BITS * b[:, w0:w0 + wc].shape[1]
            bv = packing.unpack_to_pm1(b[:, w0:w0 + wc], bits,
                                       dtype=torch.float32)
            mc = max(1, CHUNK_ELEMS // bits)
            for m0 in range(0, m, mc):
                av = packing.unpack_to_pm1(a[m0:m0 + mc, w0:w0 + wc], bits,
                                           dtype=torch.float32)
                out[m0:m0 + mc] += (av @ bv.T).to(torch.int32)
    return out


def packed_matmul_counts(a: torch.Tensor, b: torch.Tensor,
                         word_weights: torch.Tensor | None = None,
                         impl: str = "xor") -> torch.Tensor:
    """cnt[m, n] = sum_w word_weights[w] * popcount(a[m, w] ^ b[n, w]).

    a: (M, W) int32 packed rows; b: (N, W) int32 packed rows (one per
    output filter); word_weights: optional (W,) int32 (bit-plane powers for
    the first layer, Eqn 2), default all ones.  Returns (M, N) int32.

    ``impl="pm1"`` takes the +-1 matmul form unless ``word_weights`` is
    given: weighted words have no +-1 form, so they keep xor counts, as
    the reference does.
    """
    if impl == "pm1" and word_weights is None:
        total = a.shape[-1] * packing.WORD_BITS
        diff = total - pm1_dot(a, b)
        # total - dot = 2·cnt is even for every exact product: an odd value
        # means a product was rounded, and halving would hide it.
        if bool((diff & 1).any()):
            raise ArithmeticError("pm1 counts: total_bits - dot is odd, so "
                                  "the +-1 product was not exact")
        return diff >> 1
    if impl not in ("xor", "pm1"):
        raise ValueError(f"unknown count impl {impl!r}; want 'xor' or "
                         f"'pm1'")
    m, w = a.shape
    n = b.shape[0]
    wc = max(1, min(w, CHUNK_ELEMS // max(n, 1)))
    mc = max(1, CHUNK_ELEMS // (max(n, 1) * wc))
    out = torch.zeros((m, n), dtype=torch.int32, device=a.device)
    for w0 in range(0, w, wc):
        bw = b[None, :, w0:w0 + wc]
        ww = None if word_weights is None else word_weights[w0:w0 + wc]
        for m0 in range(0, m, mc):
            c = packing.popcount(a[m0:m0 + mc, None, w0:w0 + wc] ^ bw)
            if ww is not None:
                c = c * ww
            out[m0:m0 + mc] += torch.sum(c, dim=-1, dtype=torch.int32)
    return out


def packed_matmul_dot(a: torch.Tensor, b: torch.Tensor,
                      k_valid: int) -> torch.Tensor:
    """Binary dot products (paper Eqn 1): (M, N) int32 in +-1 arithmetic."""
    return k_valid - 2 * packed_matmul_counts(a, b)


def mxu_pm1_matmul(a: torch.Tensor, b: torch.Tensor, k_valid: int,
                   channels: int | None = None) -> torch.Tensor:
    """Unpack both operands to +-1 and take a dense matmul: the +-1 dots
    over the first ``channels`` bits (default all ``32·W``).  Bits past
    ``channels`` are sliced away before the product, so no pad correction
    is needed.  ``k_valid`` is the reference's signature; like the
    reference, the result does not use it.

    The reference unpacks to bf16 and accumulates in float32; this takes
    float32 throughout, in full float32, with the same bound: exact for
    ``channels <= 2^24``.  :func:`pm1_dot` is exact at every width.
    """
    del k_valid
    w = a.shape[-1]
    channels = channels if channels is not None else w * packing.WORD_BITS
    av = packing.unpack_to_pm1(a, channels, dtype=torch.float32)
    bv = packing.unpack_to_pm1(b, channels, dtype=torch.float32)
    with full_float32():
        out = av @ bv.T
    return out.to(torch.int32)


def binary_dense_counts(x_packed: torch.Tensor, w_packed: torch.Tensor,
                        impl: str = "xor") -> torch.Tensor:
    """Fully-connected counts: x (..., W) @ filters (O, W) -> (..., O)."""
    lead = x_packed.shape[:-1]
    flat = x_packed.reshape(-1, x_packed.shape[-1])
    cnt = packed_matmul_counts(flat, w_packed, impl=impl)
    return cnt.reshape(lead + (w_packed.shape[0],))


def binary_dense_dot(x_packed: torch.Tensor, w_packed: torch.Tensor,
                     k_valid: int) -> torch.Tensor:
    return k_valid - 2 * binary_dense_counts(x_packed, w_packed)
