"""The port's sub-arguments one by one (tests/test_arguments.py on the
port, n = 8, on the CPU): an honest instance proves and its deferred checks
verify; a tampered one makes the accumulator reject; and each proof is byte
for byte the JAX package's for the same seeds (same transcript order, same
order of draws). Instances are built with the host oracle."""

import io
import random

import pytest
import torch

from go_curdleproofs_tpu.models import grand_product as jgrand_product
from go_curdleproofs_tpu.models import inner_product as jinner_product
from go_curdleproofs_tpu.models import same_multiscalar as jsame_multiscalar
from go_curdleproofs_tpu.models import same_permutation as jsame_permutation
from go_curdleproofs_tpu.models import same_scalar as jsame_scalar
from go_curdleproofs_tpu.models.group_commitment import \
    GroupCommitment as JGroupCommitment
from go_curdleproofs_tpu.utils.rand import Rand as JRand
from go_curdleproofs_tpu.utils.transcript import Transcript as JTranscript
from go_curdleproofs_tpu_torch.models import (grand_product, inner_product,
                                              same_multiscalar,
                                              same_permutation, same_scalar)
from go_curdleproofs_tpu_torch.models.group_commitment import GroupCommitment
from go_curdleproofs_tpu_torch.models.msm_accumulator import MsmAccumulator
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils.rand import Rand
from go_curdleproofs_tpu_torch.utils.transcript import Transcript

torch.set_num_threads(1)
CPU = torch.device("cpu")
N = 8
N_BLINDERS = 4
ELL = N - N_BLINDERS


def _bytes(proof) -> bytes:
    buf = io.BytesIO()
    proof.serialize(buf)
    return buf.getvalue()


def _roundtrip(proof, cls) -> None:
    data = _bytes(proof)
    assert _bytes(cls.from_reader(io.BytesIO(data))) == data


def _sum(pts):
    acc = None
    for p in pts:
        acc = fh.g1_add(acc, p)
    return acc


def test_group_commitment_homomorphism_and_serde():
    rand = Rand(0)
    g, h = rand.get_g1(), rand.get_g1()
    t1, t2 = rand.get_g1(), rand.get_g1()
    r1, r2 = rand.get_fr(), rand.get_fr()
    c1 = GroupCommitment.new(g, h, t1, r1)
    c2 = GroupCommitment.new(g, h, t2, r2)
    assert c1.add(c2).eq(
        GroupCommitment.new(g, h, fh.g1_add(t1, t2), (r1 + r2) % fh.R))
    a = rand.get_fr()
    assert c1.mul(a).eq(
        GroupCommitment.new(g, h, fh.g1_mul(t1, a), r1 * a % fh.R))
    _roundtrip(c1, GroupCommitment)
    assert vars(c1) == vars(JGroupCommitment.new(g, h, t1, r1))


@pytest.mark.parametrize("n", [1, 4])
def test_accumulator_accepts_true_claims(n):
    rand = Rand(n)
    pts, xs, ys = rand.get_g1s(n), rand.get_frs(n), rand.get_frs(n)
    acc = MsmAccumulator(device=CPU)
    acc.accumulate_check(fh.g1_msm(pts, xs), xs, pts, rand)
    acc.accumulate_check(fh.g1_msm(pts, ys), ys, pts, rand)
    assert acc.verify()


def test_accumulator_rejects_bad_claim():
    rand = Rand(5)
    pts, xs = rand.get_g1s(4), rand.get_frs(4)
    acc = MsmAccumulator(device=CPU)
    acc.accumulate_check(fh.g1_add(fh.g1_msm(pts, xs), fh.G1_GEN), xs, pts,
                         rand)
    assert not acc.verify()


# -- same scalar ------------------------------------------------------------------

def _same_scalar_instance(rand_cls, mod, gc):
    rand = rand_cls(0)
    crs = mod.CRS(rand.get_g1(), rand.get_g1(), rand.get_g1())
    R, S = rand.get_g1(), rand.get_g1()
    k, r_t, r_u = rand.get_fr(), rand.get_fr(), rand.get_fr()
    T = gc.new(crs.gt, crs.h, fh.g1_mul(R, k), r_t)
    U = gc.new(crs.gu, crs.h, fh.g1_mul(S, k), r_u)
    return rand, crs, R, S, T, U, k, r_t, r_u


def test_same_scalar_complete_sound_and_jax_bytes():
    rand, crs, R, S, T, U, k, r_t, r_u = _same_scalar_instance(
        Rand, same_scalar, GroupCommitment)
    proof = same_scalar.prove(crs, R, S, T, U, k, r_t, r_u, Transcript(b"t"),
                              rand)
    assert same_scalar.verify(proof, crs, R, S, T, U, Transcript(b"t"))
    acc = MsmAccumulator(device=CPU)
    assert same_scalar.verify(proof, crs, R, S, T, U, Transcript(b"t"), acc,
                              rand)
    assert acc.verify()
    _roundtrip(proof, same_scalar.Proof)

    jrand, jcrs, *_, jT, jU, _, _, _ = _same_scalar_instance(
        JRand, jsame_scalar, JGroupCommitment)
    jproof = jsame_scalar.prove(jcrs, R, S, jT, jU, k, r_t, r_u,
                                JTranscript(b"t"), jrand)
    assert _bytes(jproof) == _bytes(proof)

    bad = same_scalar.prove(crs, R, S, T, U, (k + 1) % fh.R, r_t, r_u,
                            Transcript(b"t"), rand)
    assert not same_scalar.verify(bad, crs, R, S, T, U, Transcript(b"t"))
    acc = MsmAccumulator(device=CPU)
    same_scalar.verify(bad, crs, R, S, T, U, Transcript(b"t"), acc, rand)
    assert not acc.verify()


# -- inner product ----------------------------------------------------------------

@pytest.fixture(scope="module")
def ipa():
    rand = Rand(0)
    gs, us = rand.get_g1s(N), rand.get_frs(N)
    gs_prime = [fh.g1_mul(g, u) for g, u in zip(gs, us)]
    h = rand.get_g1()
    cs, ds = rand.get_frs(N), rand.get_frs(N)
    z = fh.fr_inner_product(cs, ds)
    C, D = fh.g1_msm(gs, cs), fh.g1_msm(gs_prime, ds)
    crs = inner_product.CRS(gs, gs_prime, h)
    proof = inner_product.prove(crs, C, D, z, list(cs), list(ds),
                                Transcript(b"ipa"), rand, device=CPU)
    return dict(rand=rand, crs=crs, us=us, C=C, D=D, z=z, cs=cs, ds=ds,
                proof=proof)


def _ipa_verdict(f, z):
    acc = MsmAccumulator(device=CPU)
    assert inner_product.verify(f["proof"], f["crs"], f["C"], f["D"], z,
                                f["us"], Transcript(b"ipa"), acc, Rand(9))
    return acc.verify()


def test_inner_product_complete(ipa):
    assert _ipa_verdict(ipa, ipa["z"])
    assert len(ipa["proof"].l_cs) == 3
    _roundtrip(ipa["proof"], inner_product.Proof)


def test_inner_product_wrong_z_kills_the_accumulator(ipa):
    assert not _ipa_verdict(ipa, (ipa["z"] + 1) % fh.R)


def test_inner_product_bytes_match_jax(ipa):
    rand = JRand(0)                    # replay the fixture's draws:
    rand.get_g1s(N), rand.get_frs(N), rand.get_g1()        # gs, us, h
    rand.get_frs(N), rand.get_frs(N)                       # cs, ds
    crs = ipa["crs"]
    jproof = jinner_product.prove(
        jinner_product.CRS(crs.gs, crs.gs_prime, crs.h), ipa["C"], ipa["D"],
        ipa["z"], list(ipa["cs"]), list(ipa["ds"]), JTranscript(b"ipa"), rand)
    assert _bytes(jproof) == _bytes(ipa["proof"])


def test_inner_product_rejects_bad_lengths(ipa):
    crs = ipa["crs"]
    bad_crs = inner_product.CRS(crs.gs[:6], crs.gs_prime[:6], crs.h)
    with pytest.raises(ValueError):
        inner_product.prove(bad_crs, ipa["C"], ipa["D"], ipa["z"],
                            list(ipa["cs"][:6]), list(ipa["ds"][:6]),
                            Transcript(b"ipa"), Rand(1), device=CPU)
    with pytest.raises(ValueError):
        inner_product.prove(crs, ipa["C"], ipa["D"], ipa["z"],
                            list(ipa["cs"]), list(ipa["ds"][:4]),
                            Transcript(b"ipa"), Rand(1), device=CPU)


def test_ipa_blinders_satisfy_both_constraints():
    rand = Rand(3)
    cs, ds = rand.get_frs(N), rand.get_frs(N)
    rs, zs = inner_product.generate_ipa_blinders(rand, cs, ds)
    assert (fh.fr_inner_product(rs, ds) + fh.fr_inner_product(zs, cs)) \
        % fh.R == 0
    assert fh.fr_inner_product(rs, zs) == 0
    jr = JRand(3)
    jr.get_frs(N), jr.get_frs(N)
    assert (rs, zs) == jinner_product.generate_ipa_blinders(jr, cs, ds)


# -- grand product ------------------------------------------------------------------

@pytest.fixture(scope="module")
def gpa():
    rand = Rand(0)
    crs = grand_product.CRS(rand.get_g1s(ELL), rand.get_g1s(N_BLINDERS),
                            rand.get_g1())
    bs, r_bs = rand.get_frs(ELL), rand.get_frs(N_BLINDERS)
    result = 1
    for b in bs:
        result = result * b % fh.R
    B = fh.g1_add(fh.g1_msm(crs.gs, bs), fh.g1_msm(crs.hs, r_bs))
    jrand = JRand(0)
    jrand.get_g1s(ELL), jrand.get_g1s(N_BLINDERS), jrand.get_g1()
    jrand.get_frs(ELL), jrand.get_frs(N_BLINDERS)
    proof = grand_product.prove(crs, B, result, bs, r_bs, Transcript(b"gpa"),
                                rand, device=CPU)
    return dict(crs=crs, gsum=_sum(crs.gs), hsum=_sum(crs.hs), B=B,
                result=result, bs=bs, r_bs=r_bs, proof=proof, jrand=jrand)


def _gpa_verdict(f, B, result):
    acc = MsmAccumulator(device=CPU)
    assert grand_product.verify(f["proof"], f["crs"], f["gsum"], f["hsum"], B,
                                result, N_BLINDERS, Transcript(b"gpa"), acc,
                                Rand(9))
    return acc.verify()


def test_grand_product_complete_and_jax_bytes(gpa):
    assert _gpa_verdict(gpa, gpa["B"], gpa["result"])
    _roundtrip(gpa["proof"], grand_product.Proof)
    crs = gpa["crs"]
    jproof = jgrand_product.prove(
        jgrand_product.CRS(crs.gs, crs.hs, crs.h), gpa["B"], gpa["result"],
        gpa["bs"], gpa["r_bs"], JTranscript(b"gpa"), gpa["jrand"])
    assert _bytes(jproof) == _bytes(gpa["proof"])


@pytest.mark.parametrize("case", ["result", "commitment"])
def test_grand_product_tamper_kills_the_accumulator(gpa, case):
    if case == "result":
        assert not _gpa_verdict(gpa, gpa["B"], (gpa["result"] + 1) % fh.R)
    else:
        assert not _gpa_verdict(gpa, fh.g1_add(gpa["B"], fh.G1_GEN),
                                gpa["result"])


# -- same permutation ---------------------------------------------------------------

@pytest.fixture(scope="module")
def same_perm():
    rand = Rand(0)
    crs = same_permutation.CRS(rand.get_g1s(ELL), rand.get_g1s(N_BLINDERS),
                               rand.get_g1())
    perm = list(range(ELL))
    random.Random(0).shuffle(perm)
    as_ = rand.get_frs(ELL)
    rs_a, rs_m = rand.get_frs(N_BLINDERS), rand.get_frs(N_BLINDERS)
    A = fh.g1_add(fh.g1_msm(crs.gs, same_permutation.permute(as_, perm)),
                  fh.g1_msm(crs.hs, rs_a))
    M = fh.g1_add(fh.g1_msm(crs.gs, perm), fh.g1_msm(crs.hs, rs_m))
    proof = same_permutation.prove(crs, A, M, as_, perm, rs_a, rs_m,
                                   Transcript(b"sp"), rand, device=CPU)
    return dict(crs=crs, gsum=_sum(crs.gs), hsum=_sum(crs.hs), A=A, M=M,
                as_=as_, proof=proof)


def _same_perm_verdict(f, as_):
    acc = MsmAccumulator(device=CPU)
    assert same_permutation.verify(f["proof"], f["crs"], f["gsum"], f["hsum"],
                                   f["A"], f["M"], as_, N_BLINDERS,
                                   Transcript(b"sp"), acc, Rand(9))
    return acc.verify()


def test_same_permutation_complete(same_perm):
    assert _same_perm_verdict(same_perm, same_perm["as_"])
    _roundtrip(same_perm["proof"], same_permutation.Proof)
    assert same_permutation.permute("abcd", [2, 0, 3, 1]) == list("cadb") \
        == jsame_permutation.permute("abcd", [2, 0, 3, 1])


def test_same_permutation_wrong_permutation_kills_the_accumulator(same_perm):
    bad = list(same_perm["as_"])
    bad[0], bad[1] = bad[1], bad[0]
    assert not _same_perm_verdict(same_perm, bad)


# -- same multiscalar ---------------------------------------------------------------

@pytest.fixture(scope="module")
def same_msm():
    rand = Rand(0)
    G, T, U = rand.get_g1s(N), rand.get_g1s(N), rand.get_g1s(N)
    T[5] = None                              # the shuffle pads with infinity
    x = rand.get_frs(N)
    live = [(t, s) for t, s in zip(T, x) if t is not None]
    A, Z_u = fh.g1_msm(G, x), fh.g1_msm(U, x)
    Z_t = fh.g1_msm([t for t, _ in live], [s for _, s in live])
    jrand = JRand(0)
    jrand.get_g1s(N), jrand.get_g1s(N), jrand.get_g1s(N), jrand.get_frs(N)
    proof = same_multiscalar.prove(G, A, Z_t, Z_u, T, U, list(x),
                                   Transcript(b"smsm"), rand, device=CPU)
    return dict(G=G, T=T, U=U, x=x, A=A, Z_t=Z_t, Z_u=Z_u, proof=proof,
                jrand=jrand)


def _same_msm_verdict(f, A):
    acc = MsmAccumulator(device=CPU)
    assert same_multiscalar.verify(f["proof"], f["G"], A, f["Z_t"], f["Z_u"],
                                   f["T"], f["U"], Transcript(b"smsm"), acc,
                                   Rand(9))
    return acc.verify()


def test_same_multiscalar_complete_and_jax_bytes(same_msm):
    f = same_msm
    assert _same_msm_verdict(f, f["A"])
    _roundtrip(f["proof"], same_multiscalar.Proof)
    jproof = jsame_multiscalar.prove(f["G"], f["A"], f["Z_t"], f["Z_u"],
                                     f["T"], f["U"], list(f["x"]),
                                     JTranscript(b"smsm"), f["jrand"])
    assert _bytes(jproof) == _bytes(f["proof"])


def test_same_multiscalar_wrong_commitment_kills_the_accumulator(same_msm):
    assert not _same_msm_verdict(same_msm, fh.g1_add(same_msm["A"],
                                                     fh.G1_GEN))
