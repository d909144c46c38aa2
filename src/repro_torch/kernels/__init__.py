"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built by ``build``)
with the plain PyTorch version of each beside it.

bitplane_pack            K4: first-layer bit-plane split + pack (Eqn 2)
fused_conv_bn_binarize   K2: fused xor-popcount matmul + threshold + pack
direct_conv_bn_binarize  K3: direct conv + threshold + pack (+ OR-pool)
chain_conv               K5: a region of conv / OR-pool stages in one launch
xnor_popcount_matmul     K1: weighted xor-popcount count matmul
mxu_pm1_matmul           K6: +-1 dots on the tensor cores (int8 mma)
flash_attention          K7: GQA attention forward, online softmax (bf16 mma)
ops                      backend dispatch (port backend <-> JAX mode)
"""
