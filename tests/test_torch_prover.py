"""The port's host-orchestrated prover on the CPU, end to end.

  * golden vectors (tests/golden_vectors.json): the ell=12 shuffle proof,
    the ell=12 Whisk proof with its post-trackers and the tracker proof come
    out byte for byte (ell=60 and ELL=124 under `slow`);
  * a fresh ell=4 proof of the port is accepted by the JAX package's
    verifier and by the port's, and the tamper cases of
    tests/test_curdleproof.py are rejected by the port;
  * the deep tamper of tests/test_midsize.py:42-46 (a swapped fold
    cross-term) is rejected by the port.

Exact: integers and bytes, no tolerance."""

import functools
import io
import json
import os

import pytest
import torch

from go_curdleproofs_tpu.models import curdleproof as jcurdleproof
from go_curdleproofs_tpu_torch import convert
from go_curdleproofs_tpu_torch.models import curdleproof, whisk
from go_curdleproofs_tpu_torch.models.same_permutation import permute
from go_curdleproofs_tpu_torch.utils import codec
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils.rand import Rand
from go_curdleproofs_tpu.utils.rand import Rand as JRand

torch.set_num_threads(1)
CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))

with open(os.path.join(HERE, "golden_vectors.json")) as f:
    GOLDEN = json.load(f)


def _proof_bytes(proof) -> bytes:
    buf = io.BytesIO()
    proof.serialize(buf)
    return buf.getvalue()


def _prove_shuffle_vector(vec):
    """The instance and proof of one golden shuffle vector, built as
    tests/test_golden.py builds them."""
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
                              device=CPU)
    return crs, Rs, Ss, Ts, Us, M, proof


@functools.lru_cache(maxsize=None)
def _golden_ell12():
    return _prove_shuffle_vector(GOLDEN["shuffle"][0])


def test_golden_ell12_shuffle_proof_bytes():
    vec = GOLDEN["shuffle"][0]
    assert vec["ell"] == 12
    crs, Rs, Ss, Ts, Us, M, proof = _golden_ell12()
    assert codec.g1_to_bytes(M).hex() == vec["m_hex"]
    assert _proof_bytes(proof).hex() == vec["proof_hex"]


def test_deep_fold_tamper_rejected():
    """tests/test_midsize.py:42-46 at the golden proof's four rounds: a
    swapped cross-term of the last same-multiscalar round."""
    crs, Rs, Ss, Ts, Us, M, proof = _golden_ell12()
    data = whisk.WhiskShuffleProof(M, proof).serialize()
    assert len(data) == whisk.expected_shuffle_proof_size(12)
    ok = whisk.WhiskShuffleProof.from_bytes(data, codec.DecodePool(CPU))
    assert _proof_bytes(ok.proof) == _proof_bytes(proof)
    assert curdleproof.verify(ok.proof, crs, Rs, Ss, Ts, Us, M, Rand(1),
                              device=CPU)
    bad = whisk.WhiskShuffleProof.from_bytes(data, codec.DecodePool(CPU))
    sms = bad.proof.proof_same_multiscalar
    assert len(sms.l_a) == 4
    sms.l_a[3] = sms.r_a[3]
    assert not curdleproof.verify(bad.proof, crs, Rs, Ss, Ts, Us, M, Rand(2),
                                  device=CPU)


def test_whisk_proof_from_bytes_without_a_pool():
    """With no DecodePool every point decodes on the host, as the JAX
    package's from_bytes(data) does."""
    crs, Rs, Ss, Ts, Us, M, proof = _golden_ell12()
    data = whisk.WhiskShuffleProof(M, proof).serialize()
    got = whisk.WhiskShuffleProof.from_bytes(data)
    assert got.m == M and isinstance(got.proof.a, tuple)
    assert got.serialize() == data
    assert curdleproof.verify(got.proof, crs, Rs, Ss, Ts, Us, M, Rand(3),
                              device=CPU)


def _golden_whisk_pre(vec):
    r = Rand(vec["tracker_seed"])
    pre = []
    for _ in range(vec["ell"]):
        rr, kk = r.get_fr(), r.get_fr()
        pre.append(whisk.WhiskTracker.from_points(
            fh.g1_mul(fh.G1_GEN, rr), fh.g1_mul(fh.G1_GEN, rr * kk % fh.R)))
    return pre


def test_golden_whisk_proof_and_post_trackers_bytes():
    vec = GOLDEN["whisk"]
    crs = curdleproof.generate_crs(vec["ell"], Rand(vec["crs_seed"]),
                                   device=CPU)
    post, proof = whisk.generate_whisk_shuffle_proof(
        crs, _golden_whisk_pre(vec), Rand(vec["prove_seed"]), device=CPU)
    assert proof.hex() == vec["proof_hex"]
    assert "".join((t.r_g + t.k_r_g).hex()
                   for t in post) == vec["post_trackers_hex"]


def test_golden_tracker_proof_bytes():
    vec = GOLDEN["tracker"]
    k = int(vec["k"], 16)
    r_g = fh.g1_mul(fh.G1_GEN, vec["r"])
    tracker = whisk.WhiskTracker.from_points(r_g, fh.g1_mul(r_g, k))
    tp = whisk.generate_whisk_tracker_proof(tracker, k,
                                            Rand(vec["rand_seed"]))
    assert tp.hex() == vec["proof_hex"] and len(tp) == 128
    assert whisk.is_valid_whisk_tracker_proof(
        tracker, codec.g1_to_bytes(fh.g1_mul(fh.G1_GEN, k)), tp)
    assert whisk.TrackerProof.from_bytes(tp).serialize() == tp


def test_expected_shuffle_proof_sizes():
    assert whisk.expected_shuffle_proof_size() == 4576
    assert whisk.expected_shuffle_proof_size(12) == \
        len(GOLDEN["whisk"]["proof_hex"]) // 2
    with pytest.raises(ValueError):
        whisk.expected_shuffle_proof_size(13)


# -- a fresh ell=4 proof: tests/test_curdleproof.py on the port -----------------

ELL = 4


@pytest.fixture(scope="module")
def fresh():
    rand = Rand(0)
    crs = curdleproof.generate_crs(ELL, rand, device=CPU)
    Rs, Ss = rand.get_g1s(ELL), rand.get_g1s(ELL)
    perm = rand.generate_permutation(ELL)
    k = rand.get_fr()
    Ts, Us, M, rs_m = curdleproof.shuffle_permute_commit(
        crs.gs, crs.hs, Rs, Ss, perm, k, rand, device=CPU)
    proof = curdleproof.prove(crs, Rs, Ss, Ts, Us, M, perm, k, rs_m, rand,
                              device=CPU)
    return dict(crs=crs, Rs=Rs, Ss=Ss, Ts=Ts, Us=Us, M=M, perm=perm, k=k,
                proof=proof)


def _verify(f, **changed):
    a = {**f, **changed}
    return curdleproof.verify(a["proof"], a["crs"], a["Rs"], a["Ss"],
                              a["Ts"], a["Us"], a["M"], Rand(77), device=CPU)


def test_fresh_proof_accepted_by_port_and_by_jax_verifier(fresh):
    assert _verify(fresh)
    jproof = jcurdleproof.Proof.from_reader(
        io.BytesIO(_proof_bytes(fresh["proof"])))
    jcrs = jcurdleproof.CRS(**convert.crs_to_affine(fresh["crs"]))
    assert jcurdleproof.verify(jproof, jcrs, fresh["Rs"], fresh["Ss"],
                               fresh["Ts"], fresh["Us"], fresh["M"],
                               JRand(77))


def test_fresh_proof_equals_jax_provers_bytes(fresh):
    """The same seeds through the JAX package's prover give the same bytes
    (the transcript order and the order of draws are the contract)."""
    rand = JRand(0)
    jcrs = jcurdleproof.generate_crs(ELL, rand)
    assert vars(jcrs) == vars(fresh["crs"])
    Rs, Ss = rand.get_g1s(ELL), rand.get_g1s(ELL)
    perm = rand.generate_permutation(ELL)
    k = rand.get_fr()
    Ts, Us, M, rs_m = jcurdleproof.shuffle_permute_commit(
        jcrs.gs, jcrs.hs, Rs, Ss, perm, k, rand)
    assert (Ts, Us, M) == (fresh["Ts"], fresh["Us"], fresh["M"])
    jproof = jcurdleproof.prove(jcrs, Rs, Ss, Ts, Us, M, perm, k, rs_m, rand)
    assert _proof_bytes(jproof) == _proof_bytes(fresh["proof"])


def test_shuffle_relation_holds(fresh):
    k, perm = fresh["k"], fresh["perm"]
    assert fresh["Ts"] == permute([fh.g1_mul(r, k) for r in fresh["Rs"]],
                                  perm)
    assert fresh["Us"] == permute([fh.g1_mul(s, k) for s in fresh["Ss"]],
                                  perm)


def _tamper(f, case):
    if case == "swapped_inputs":
        return dict(Rs=f["Ss"], Ss=f["Rs"])
    if case == "wrong_permutation_applied":
        ts = list(f["Ts"])
        ts[0], ts[1] = ts[1], ts[0]
        return dict(Ts=ts)
    if case == "tampered_m":
        return dict(M=fh.g1_add(f["M"], fh.G1_GEN))
    assert case == "different_randomizer"
    k2 = (f["k"] + 1) % fh.R
    return dict(Ts=permute([fh.g1_mul(r, k2) for r in f["Rs"]], f["perm"]))


@pytest.mark.parametrize("case", ["swapped_inputs",
                                  "wrong_permutation_applied", "tampered_m",
                                  "different_randomizer"])
def test_tampered_instance_rejected(fresh, case):
    assert not _verify(fresh, **_tamper(fresh, case))


def test_zero_randomizer_raises(fresh):
    with pytest.raises(ValueError):
        _verify(fresh, Ts=[None] * ELL)


def test_serialization_roundtrip_still_verifies(fresh):
    data = _proof_bytes(fresh["proof"])
    p2 = curdleproof.Proof.from_reader(io.BytesIO(data))
    assert _proof_bytes(p2) == data
    assert _verify(fresh, proof=p2)


# -- long runs -------------------------------------------------------------------

@pytest.mark.slow
def test_golden_ell60_shuffle_proof_bytes():
    vec = GOLDEN["shuffle"][1]
    assert vec["ell"] == 60
    *_, M, proof = _prove_shuffle_vector(vec)
    assert codec.g1_to_bytes(M).hex() == vec["m_hex"]
    assert _proof_bytes(proof).hex() == vec["proof_hex"]


@pytest.mark.slow
def test_midsize_ell28_roundtrip_and_tamper():
    """tests/test_midsize.py on the port: five folding rounds."""
    rand = Rand(0x31D)
    ell = 28
    crs = curdleproof.generate_crs(ell, rand, device=CPU)
    Rs, Ss = rand.get_g1s(ell), rand.get_g1s(ell)
    perm = rand.generate_permutation(ell)
    k = rand.get_fr()
    Ts, Us, M, rs_m = curdleproof.shuffle_permute_commit(
        crs.gs, crs.hs, Rs, Ss, perm, k, rand, device=CPU)
    proof = curdleproof.prove(crs, Rs, Ss, Ts, Us, M, perm, k, rs_m, rand,
                              device=CPU)
    assert len(proof.proof_same_multiscalar.l_a) == 5
    assert curdleproof.verify(proof, crs, Rs, Ss, Ts, Us, M, Rand(1),
                              device=CPU)
    data = whisk.WhiskShuffleProof(M, proof).serialize()
    assert len(data) == whisk.expected_shuffle_proof_size(ell)
    bad = whisk.WhiskShuffleProof.from_bytes(data, codec.DecodePool(CPU))
    bad.proof.proof_same_multiscalar.l_a[3] = \
        bad.proof.proof_same_multiscalar.r_a[3]
    assert not curdleproof.verify(bad.proof, crs, Rs, Ss, Ts, Us, M, Rand(2),
                                  device=CPU)


@pytest.mark.slow
def test_ell124_prove_and_verify_on_cpu():
    """The deployment size on the CPU path: prove from the fixture's
    pre-trackers, verify with the port's verifier."""
    with open(os.path.join(HERE, "fixture_whisk_ell124.json")) as f:
        fx = json.load(f)
    crs = curdleproof.generate_crs(fx["ell"], Rand(fx["crs_seed"]),
                                   device=CPU)
    pre = [whisk.WhiskTracker(bytes.fromhex(a), bytes.fromhex(b))
           for a, b in fx["instances"][0]["pre"]]
    post, proof = whisk.generate_whisk_shuffle_proof(crs, pre, Rand(5),
                                                     device=CPU)
    assert len(proof) == whisk.WHISK_SHUFFLE_PROOF_SIZE
    assert whisk.is_valid_whisk_shuffle_proof(crs, pre, post, proof, Rand(6),
                                              device=CPU)
