"""PhoneBit core on torch tensors (counterpart of ``repro.core``).

packing             channel compression, NHWC packed layout, SWAR popcount
bitplanes           first-layer bit-plane decomposition (Eqn 2)
layer_integration   conv+BN+sign folded to integer thresholds (Eqns 3-9)
binary_ops          counts in xor (Eqn 1) and +-1 matmul form
binary_conv         packed conv / dense / OR-pool
bnn_model           layer specs, numpy-seeded init, packed and float
                    oracles, trained params -> unfused graph
converter           trained params -> packed artifact (Fig 2), .npz format
"""
