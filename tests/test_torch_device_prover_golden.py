"""The golden vectors (tests/golden_vectors.json, generated by the JAX
package) reproduced byte for byte by the port's device-resident prover on
the CPU: the ell=12 shuffle proof through `curdleproof.prove` and the ell=12
Whisk proof with its post-trackers through
`whisk.generate_whisk_shuffle_proof`, both with prover="device" (ell=60
under `slow`). The golden bytes stand in for the JAX package's own full
device prove, which is not run on the CPU."""

import io
import json
import os

import pytest
import torch

from go_curdleproofs_tpu_torch.models import curdleproof, whisk
from go_curdleproofs_tpu_torch.utils import codec
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils.rand import Rand

torch.set_num_threads(1)
CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))

with open(os.path.join(HERE, "golden_vectors.json")) as f:
    GOLDEN = json.load(f)


def _device_shuffle_proof(vec):
    ell = vec["ell"]
    crs = curdleproof.generate_crs(ell, Rand(vec["crs_seed"]), device=CPU)
    r = Rand(vec["inst_seed"])
    Rs, Ss = r.get_g1s(ell), r.get_g1s(ell)
    rp = Rand(vec["prove_seed"])
    perm = rp.generate_permutation(ell)
    k = rp.get_fr()
    Ts, Us, M, rs_m = curdleproof.shuffle_permute_commit(
        crs.gs, crs.hs, Rs, Ss, perm, k, rp, device=CPU)
    proof = curdleproof.prove(crs, Rs, Ss, Ts, Us, M, perm, k, rs_m, rp,
                              device=CPU, prover="device")
    buf = io.BytesIO()
    proof.serialize(buf)
    return codec.g1_to_bytes(M).hex(), buf.getvalue().hex()


def test_golden_ell12_shuffle_proof_bytes_device_prover():
    vec = GOLDEN["shuffle"][0]
    assert vec["ell"] == 12
    assert _device_shuffle_proof(vec) == (vec["m_hex"], vec["proof_hex"])


@pytest.mark.slow
def test_golden_ell60_shuffle_proof_bytes_device_prover():
    vec = GOLDEN["shuffle"][1]
    assert vec["ell"] == 60
    assert _device_shuffle_proof(vec) == (vec["m_hex"], vec["proof_hex"])


def test_golden_whisk_proof_and_post_trackers_bytes_device_prover():
    vec = GOLDEN["whisk"]
    crs = curdleproof.generate_crs(vec["ell"], Rand(vec["crs_seed"]),
                                   device=CPU)
    r = Rand(vec["tracker_seed"])
    pre = []
    for _ in range(vec["ell"]):
        rr, kk = r.get_fr(), r.get_fr()
        pre.append(whisk.WhiskTracker.from_points(
            fh.g1_mul(fh.G1_GEN, rr), fh.g1_mul(fh.G1_GEN, rr * kk % fh.R)))
    post, proof = whisk.generate_whisk_shuffle_proof(
        crs, pre, Rand(vec["prove_seed"]), device=CPU, prover="device")
    assert proof.hex() == vec["proof_hex"]
    assert "".join((t.r_g + t.k_r_g).hex()
                   for t in post) == vec["post_trackers_hex"]
