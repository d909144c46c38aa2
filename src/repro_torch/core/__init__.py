"""PhoneBit core on torch tensors (counterpart of ``repro.core``).

packing             channel compression, NHWC packed layout, SWAR popcount
bitplanes           first-layer bit-plane decomposition (Eqn 2)
layer_integration   conv+BN+sign folded to integer thresholds (Eqns 3-9)
binary_ops          chunked xor+popcount counts (Eqn 1)
binary_conv         packed conv / dense / OR-pool
bnn_model           layer specs, numpy-seeded init, flat packed oracle
converter           trained params -> packed artifact (Fig 2), .npz format
"""
