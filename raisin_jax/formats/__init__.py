"""Exact `.rsn` wire-format codecs (host oracles).

Each module implements one reference codec's byte-exact wire format with a
straightforward host implementation. These serve three roles:

1. the correctness oracle for the device (JAX/Pallas) kernels in
   ``raisin_jax.ops`` — property tests assert byte equality;
2. golden-format compatibility with files produced by the reference
   implementation (go-compression/raisin);
3. the fallback compute path on hosts without an accelerator.
"""
