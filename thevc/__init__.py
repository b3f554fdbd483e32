"""thevc — an HEVC (H.265, HM-8.x draft era) encode/decode framework in JAX.

A from-scratch re-design of the JCT-VC HM reference software with a
device-first architecture:

- Dense per-block math (transforms, intra/inter prediction, interpolation,
  distortion, deblocking, SAO) runs as batched JAX kernels over whole
  CTU grids per frame, on the GPU.
- The inherently sequential CABAC entropy stage runs as a host-side pass
  (Python reference implementation + native C++ fast path) fed by
  device-computed syntax-element tensors.
- Multi-device scaling (multi-stream batch encode/decode, frame pipelining)
  is expressed with jax.sharding over a device Mesh.

Public surface mirrors TAppEncoder/TAppDecoder: the same .cfg files, the
same YUV I/O, Annex-B bitstreams, with reconstruction bit-matched against HM.
"""

__version__ = "0.1.0"
