"""Set-up that the Whisk mixes share, made through the program from the
seed: the CRS, a first tracker set, and a chain of shuffle proofs made by
the host prover, each shuffling the previous one's post-trackers as block
after block does."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from go_curdleproofs_tpu_torch.models import curdleproof, whisk
from go_curdleproofs_tpu_torch.ops import curve
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils.rand import Rand

from ..reference.worker import encode_trackers
from .seeds import derive


@dataclass
class Instance:
    pre: List
    post: List
    proof: bytes


def tracker_bytes(trackers) -> List[Tuple[bytes, bytes]]:
    return [(t.r_g, t.k_r_g) for t in trackers]


def verify_job(pre, post, proof: bytes, seed: int) -> Dict:
    """A reference worker's job: verify `proof` for these trackers, the
    sum's weights drawn from `seed`."""
    return {"op": "verify", "pre": encode_trackers(tracker_bytes(pre)),
            "post": encode_trackers(tracker_bytes(post)),
            "proof": bytes(proof).hex(), "seed": seed}


def make_crs(ell: int, seed: int, device: torch.device):
    """The CRS as crs.go draws it, from Rand(crs seed); returns (crs,
    crs seed) so that the reference can draw its own."""
    crs_seed = derive(seed, "crs")
    return curdleproof.generate_crs(ell, Rand(crs_seed), device=device), \
        crs_seed


def first_trackers(ell: int, seed: int, device: torch.device) -> List:
    """(r_i G, k r_i G) with r_i and k from the seed."""
    rand = Rand(derive(seed, "trackers"))
    rs = rand.get_frs(ell)
    k = rand.get_fr()
    r_g = curve.batch_scalar_mul([fh.G1_GEN] * ell, rs, device=device)
    kr_g = curve.batch_scalar_mul(r_g, [k] * ell, device=device)
    return [whisk.WhiskTracker.from_points(a, b) for a, b in zip(r_g, kr_g)]


def make_chain(crs, pre, count: int, seed: int,
               device: torch.device) -> List[Instance]:
    out = []
    for i in range(count):
        post, proof = whisk.generate_whisk_shuffle_proof(
            crs, pre, Rand(derive(seed, "chain", i)), device=device)
        out.append(Instance(pre, post, proof))
        pre = post
    return out
