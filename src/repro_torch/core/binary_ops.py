"""Binary matmul counts via xor + popcount (paper Eqn 1).

Counterpart of ``repro.core.binary_ops`` in its xor form: for two packed
vectors of ``k_valid`` meaningful bits, ``dot = k_valid - 2 * cnt`` with
``cnt = popcount(a ^ b)``.  The pm1 (unpack-and-matmul) form is not ported.

This is the plain PyTorch path: it broadcasts a (rows, N, words) xor cube,
so it walks the rows and the word axis in chunks to stay inside memory at
full width (unchunked, AlexNet conv1 at batch 8 would be ~9 GB).
"""

from __future__ import annotations

import torch

from repro_torch.core import packing

# Elements of one broadcast (rows, N, words) chunk: 2^24 int32 = 64 MiB,
# a few times that with the popcount temporaries.
CHUNK_ELEMS = 1 << 24


def packed_matmul_counts(a: torch.Tensor, b: torch.Tensor,
                         word_weights: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """cnt[m, n] = sum_w word_weights[w] * popcount(a[m, w] ^ b[n, w]).

    a: (M, W) int32 packed rows; b: (N, W) int32 packed rows (one per
    output filter); word_weights: optional (W,) int32 (bit-plane powers for
    the first layer, Eqn 2), default all ones.  Returns (M, N) int32.
    """
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


def binary_dense_counts(x_packed: torch.Tensor,
                        w_packed: torch.Tensor) -> torch.Tensor:
    """Fully-connected counts: x (..., W) @ filters (O, W) -> (..., O)."""
    lead = x_packed.shape[:-1]
    flat = x_packed.reshape(-1, x_packed.shape[-1])
    cnt = packed_matmul_counts(flat, w_packed)
    return cnt.reshape(lead + (w_packed.shape[0],))
