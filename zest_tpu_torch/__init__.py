"""zest-tpu-torch: the PyTorch/CUDA port of zest-tpu, for an NVIDIA H100.

A second package beside ``zest_tpu`` (the JAX reference, which it never
imports). This slice runs push → pull → generate on one card: CDC-dedup
publishing with every minted chunk re-verified by the CUDA BLAKE3 kernel
(``csrc/blake3.cu``), a pull through the cache → peer → CDN waterfall
landing every tensor in device memory, a node seeding its xorb cache to
its peers over the BT wire, and KV-cached decoding from the landed
tree. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
