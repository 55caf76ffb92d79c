"""go_curdleproofs_tpu_torch: Curdleproofs / Whisk shuffle proofs, proving
and verifying, on PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `go_curdleproofs_tpu`, which stays the reference
that the tests hold this package against. The port stands alone: it imports
torch and numpy, never jax and nothing of the JAX package, and keeps its own
copy of every host module it needs.

  utils/              host layer: bignum oracle (field_host), wire codec,
                      Merlin/STROBE transcript, the protocol's seeded Rand,
                      and the optional host C library (native.py, native/*.c)
  ops/fp.py           Fp as [..., 12] int32 Montgomery words (R = 2^384)
  ops/kernels.py      the six CUDA kernels (ops/csrc/) with plain versions
  ops/curve.py        G1 points, GLV tables, scalar multiplication, the
                      verifier's and the prover's MSM APIs
  ops/codec_batch.py  batched point decompression + subgroup check
  ops/compress_dev.py device-side point compression
  models/             accumulator, the five sub-arguments, curdleproof
                      prove/verify, Whisk shuffle and tracker proofs
  convert.py          state carried to and from the JAX package (tests)
  profile_port.py     where the time goes on the card

Every public entry point that touches a device takes it explicitly
(`device: torch.device`); nothing chooses the CPU when CUDA is missing.
"""
