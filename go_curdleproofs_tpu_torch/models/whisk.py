"""Whisk SSLE protocol layer over the port (go_curdleproofs_tpu/models/
whisk.py; whisk/whisk.go and whisk/types.go of the Go reference): fixed
sizes N=128 / ELL=124, 4576-byte shuffle proofs, 128-byte Schnorr tracker
proofs, 48-byte compressed tracker points.

A shuffle verification runs two device programs: one batched decode of
every proof and tracker point, and the accumulator's final MSM. Generating
a shuffle proof decodes the trackers in one batch, shuffles them with one
batched scalar multiplication and runs the prover the caller names
(host-orchestrated by default, or device-resident with one fetch). The
tracker proof is a Schnorr argument of a handful of host group operations
and touches no device.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..ops import codec_batch
from ..utils import codec
from ..utils import field_host as fh
from ..utils.field_host import Affine
from ..utils.rand import Rand
from ..utils.transcript import Transcript
from . import curdleproof
from .device_mode import DEFAULT_PROVER

G1POINT_SIZE = 48
N = 128
ELL = N - curdleproof.N_BLINDERS
TRACKER_PROOF_SIZE = 128
WHISK_SHUFFLE_PROOF_SIZE = 4576

LABEL_WHISK_OPENING_PROOF = b"whisk_opening_proof"
LABEL_TRACKER_OPENING_PROOF = b"tracker_opening_proof"
LABEL_TRACKER_OPENING_PROOF_CHALLENGE = b"tracker_opening_proof_challenge"

CRS = curdleproof.CRS


@dataclass
class WhiskTracker:
    """(rG, krG) as 48-byte compressed points."""
    r_g: bytes
    k_r_g: bytes

    @classmethod
    def from_points(cls, r_g: Affine, k_r_g: Affine) -> "WhiskTracker":
        return cls(codec.g1_to_bytes(r_g), codec.g1_to_bytes(k_r_g))

    def get_points(self) -> Tuple[Affine, Affine]:
        return codec.g1_from_bytes(self.r_g), codec.g1_from_bytes(self.k_r_g)


def expected_shuffle_proof_size(ell: int = ELL) -> int:
    """Wire size of a Whisk shuffle proof for `ell` trackers.

    The encoded content for ell=124 is 4536 bytes; the Go reference stores
    it in a fixed zero-padded [4576]byte array (whisk/types.go:21, 53-72:
    Serialize copies into it, FromReader ignores the tail), so the canonical
    ell pads to WHISK_SHUFFLE_PROOF_SIZE. n = ell + N_BLINDERS is the
    (power-of-two) folding length; each of the 10 L/R slices has log2(n)
    points and a u32 prefix."""
    if ell == ELL:
        return WHISK_SHUFFLE_PROOF_SIZE
    n = ell + curdleproof.N_BLINDERS
    if n & (n - 1) != 0:
        raise ValueError("ell + 4 must be a power of two")
    rounds = n.bit_length() - 1
    size = 48          # M
    size += 48 + 96 + 96 + 48 + 48        # A, T, U, R, S
    size += 48                            # sameperm B
    size += 48 + 32                       # gpa C, Rp
    size += 96 + 4 * (4 + rounds * 48) + 64   # ipa: B_c,B_d, 4 slices, c0,d0
    size += 96 + 96 + 3 * 32              # samescalar A, B, z_k, z_t, z_u
    size += 3 * 48 + 6 * (4 + rounds * 48) + 32  # samemsm
    return size


@dataclass
class WhiskShuffleProof:
    m: Affine
    proof: curdleproof.Proof

    def serialize(self) -> bytes:
        buf = io.BytesIO()
        codec.Encoder(buf).write_point(self.m)
        self.proof.serialize(buf)
        out = buf.getvalue()
        ell = (1 << len(self.proof.proof_same_multiscalar.l_a)) \
            - curdleproof.N_BLINDERS
        expected = expected_shuffle_proof_size(ell)
        if len(out) < expected:
            out = out + b"\x00" * (expected - len(out))  # fixed-array padding
        if len(out) != expected:
            raise ValueError(
                f"whisk shuffle proof size {len(out)} != {expected}")
        return out

    @classmethod
    def from_bytes(cls, data: bytes,
                   pool: Optional[codec.DecodePool] = None
                   ) -> "WhiskShuffleProof":
        """With `pool`, every point decode defers into it (one batched
        device decompression for the whole verification); without, each
        point decodes on the host. Trailing bytes (the fixed 4576-byte
        array's zero padding) are ignored."""
        buf = io.BytesIO(data)
        if pool is not None:
            buf._curdle_pool = pool
        m = codec.Decoder(buf).read_point()
        return cls(m, curdleproof.Proof.from_reader(buf))


def is_valid_whisk_shuffle_proof(crs: CRS, pre_st: List[WhiskTracker],
                                 post_st: List[WhiskTracker],
                                 proof_bytes: bytes, rand: Rand, *,
                                 device: torch.device) -> bool:
    """whisk/whisk.go:20-61 as a validity oracle: malformed or degenerate
    input (truncated proof, bad point encodings, zero randomizer) returns
    False. Errors of the device itself propagate."""
    try:
        if len(pre_st) != len(post_st):
            return False
        pool = codec.DecodePool(device)
        whisk_proof = WhiskShuffleProof.from_bytes(proof_bytes, pool)
        Rs, Ss, Ts, Us = _pool_tracker_sets(pre_st, post_st, pool)
        return curdleproof.verify(whisk_proof.proof, crs, Rs, Ss, Ts, Us,
                                  whisk_proof.m, rand, device=device)
    except (ValueError, EOFError):
        return False


def _pool_tracker_sets(pre_st, post_st, pool):
    n = len(pre_st)
    lp = [pool.add(b) for b in
          ([t.r_g for t in pre_st] + [t.k_r_g for t in pre_st]
           + [t.r_g for t in post_st] + [t.k_r_g for t in post_st])]
    return lp[:n], lp[n:2 * n], lp[2 * n:3 * n], lp[3 * n:]


def generate_whisk_shuffle_proof(
        crs: CRS, pre_trackers: List[WhiskTracker], rand: Rand, *,
        device: torch.device,
        prover: str = DEFAULT_PROVER) -> Tuple[List[WhiskTracker], bytes]:
    """whisk/whisk.go:63-114: (post trackers, proof bytes). ell is
    len(pre_trackers): ELL for the Whisk deployment, smaller powers of two
    minus 4 in tests. prover: "host" (host-orchestrated) or "device" (the
    one-fetch device-resident prover); the bytes are the same."""
    permutation = rand.generate_permutation(len(pre_trackers))
    k = rand.get_fr()

    n = len(pre_trackers)
    pts = codec_batch.batch_decompress(
        [t.r_g for t in pre_trackers] + [t.k_r_g for t in pre_trackers],
        device=device)
    Rs, Ss = pts[:n], pts[n:]

    Ts, Us, M, rs_m = curdleproof.shuffle_permute_commit(
        crs.gs, crs.hs, Rs, Ss, permutation, k, rand, device=device)

    proof = curdleproof.prove(crs, Rs, Ss, Ts, Us, M, permutation, k, rs_m,
                              rand, device=device, prover=prover)
    proof_bytes = WhiskShuffleProof(M, proof).serialize()
    post_trackers = [WhiskTracker.from_points(t, u) for t, u in zip(Ts, Us)]
    return post_trackers, proof_bytes


@dataclass
class TrackerProof:
    a: Affine
    b: Affine
    s: int

    def serialize(self) -> bytes:
        buf = io.BytesIO()
        e = codec.Encoder(buf)
        e.write_point(self.a)
        e.write_point(self.b)
        e.write_fr(self.s)
        out = buf.getvalue()
        if len(out) != TRACKER_PROOF_SIZE:
            raise ValueError(f"tracker proof size {len(out)}")
        return out

    @classmethod
    def from_bytes(cls, data: bytes) -> "TrackerProof":
        d = codec.Decoder(io.BytesIO(data))
        return cls(d.read_point(), d.read_point(), d.read_fr())


def generate_whisk_tracker_proof(tracker: WhiskTracker, k: int,
                                 rand: Rand) -> bytes:
    """Schnorr discrete-log-equality proof that kG and krG share k
    (whisk/whisk.go:149-176)."""
    r_g, k_r_g = tracker.get_points()
    k_g = fh.g1_mul(fh.G1_GEN, k)
    blinder = rand.get_fr()
    a = fh.g1_mul(fh.G1_GEN, blinder)
    b = fh.g1_mul(r_g, blinder)

    transcript = Transcript(LABEL_WHISK_OPENING_PROOF)
    transcript.append_points(LABEL_TRACKER_OPENING_PROOF,
                             k_g, fh.G1_GEN, k_r_g, r_g, a, b)
    challenge = transcript.get_and_append_challenge(
        LABEL_TRACKER_OPENING_PROOF_CHALLENGE)
    s = (blinder - challenge * k) % fh.R
    return TrackerProof(a, b, s).serialize()


def is_valid_whisk_tracker_proof(tracker: WhiskTracker, k_comm: bytes,
                                 tracker_proof_bytes: bytes) -> bool:
    """whisk/whisk.go:116-146: False (not an exception) on malformed input."""
    try:
        proof = TrackerProof.from_bytes(tracker_proof_bytes)
        r_g, k_r_g = tracker.get_points()
        k_g = codec.g1_from_bytes(k_comm)
    except (ValueError, EOFError):
        return False
    transcript = Transcript(LABEL_WHISK_OPENING_PROOF)
    transcript.append_points(LABEL_TRACKER_OPENING_PROOF,
                             k_g, fh.G1_GEN, k_r_g, r_g, proof.a, proof.b)
    challenge = transcript.get_and_append_challenge(
        LABEL_TRACKER_OPENING_PROOF_CHALLENGE)
    a_prime = fh.g1_add(fh.g1_mul(fh.G1_GEN, proof.s),
                        fh.g1_mul(k_g, challenge))
    b_prime = fh.g1_add(fh.g1_mul(r_g, proof.s),
                        fh.g1_mul(k_r_g, challenge))
    return a_prime == proof.a and b_prime == proof.b
