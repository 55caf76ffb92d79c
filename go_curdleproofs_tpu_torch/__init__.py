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
  ops/fr.py           Fr as [..., 8] int32 Montgomery words (R = 2^256)
  ops/kernels.py      the eleven CUDA kernels (ops/csrc/) with plain
                      versions: the eight of the JAX package's Pallas
                      kernels and three of the port's own (fr_mont_mul,
                      strobe_absorb_stream, strobe_challenge32)
  ops/curve.py        G1 points, GLV tables, scalar multiplication, the
                      verifier's and the prover's MSM APIs
  ops/codec_batch.py  batched point decompression + subgroup check
  ops/compress_dev.py device-side point compression
  ops/strobe_dev.py   the device-resident transcript
  models/             accumulator, the five sub-arguments, curdleproof
                      prove/verify (host and device-resident provers),
                      Whisk shuffle and tracker proofs
  parallel/           batched verification (one decode, one final MSM for
                      many proofs) and the MSM sharded over the ranks of a
                      torch.distributed process group
  convert.py          state carried to and from the JAX package (tests)
  time_kernels.py     the kernels' times on the card, two checkouts compared

Every public entry point that touches a device takes it explicitly
(`device: torch.device`); nothing chooses the CPU when CUDA is missing.
"""
