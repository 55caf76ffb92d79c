"""The port's device-resident prover on the CPU (the same chain on the
kernels' plain versions), as a whole:

  * the stand-alone device IPA and same-multiscalar provers at N=8, with
    the seeds of tests/test_device_prover2.py, byte-identical to the port's
    host provers, with the transcript in lockstep afterwards;
  * the grand-product branch (`prover="device"` hands the inner-product
    argument to the device prover on the same one-row bases);
  * the blinder pieces flag a degenerate solve;
  * the `prover` argument is validated and nothing else chooses.

The whole one-fetch prove is in tests/test_torch_device_prover_full.py, the
JAX package's device provers are held against these in
tests/test_torch_device_prover_jax.py, the golden bytes in
tests/test_torch_device_prover_golden.py. Exact: bytes, no tolerance."""

import io

import pytest
import torch

from go_curdleproofs_tpu_torch.models import (curdleproof, device_common,
                                              device_mode, device_prover2,
                                              device_prover_full,
                                              grand_product, inner_product,
                                              same_multiscalar, whisk)
from go_curdleproofs_tpu_torch.ops import fr
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils.rand import Rand
from go_curdleproofs_tpu_torch.utils.transcript import Transcript

torch.set_num_threads(1)
CPU = torch.device("cpu")
N = 8
ELL = 4


def _ser(p) -> bytes:
    b = io.BytesIO()
    p.serialize(b)
    return b.getvalue()


def ipa_instance():
    """tests/test_device_prover2.py:33-42."""
    rand = Rand(0)
    gs = rand.get_g1s(N)
    us = rand.get_frs(N)
    gsp = [fh.g1_mul(g, u) for g, u in zip(gs, us)]
    h = rand.get_g1()
    cs = rand.get_frs(N)
    ds = rand.get_frs(N)
    z = fh.fr_inner_product(cs, ds)
    return gs, gsp, h, fh.g1_msm(gs, cs), fh.g1_msm(gsp, ds), z, cs, ds


def samemsm_instance():
    """tests/test_device_prover2.py:58-65."""
    rand = Rand(1)
    gs = rand.get_g1s(N)
    T = rand.get_g1s(N)
    U = rand.get_g1s(N)
    xs = rand.get_frs(N)
    return (gs, fh.g1_msm(gs, xs), fh.g1_msm(T, xs), fh.g1_msm(U, xs), T, U,
            xs)


def test_device_ipa_byte_identical_to_host_prover():
    gs, gsp, h, C, D, z, cs, ds = ipa_instance()
    out = []
    for prover in device_mode.PROVERS:
        t, r = Transcript(b"ipa"), Rand(7)
        p = inner_product.prove(inner_product.CRS(gs, gsp, h), C, D, z,
                                list(cs), list(ds), t, r, device=CPU,
                                prover=prover)
        out.append((_ser(p), t.get_and_append_challenge(b"probe"),
                    r.get_fr()))
    assert out[0] == out[1]
    t, r = Transcript(b"ipa"), Rand(7)
    direct = device_prover2.prove_ipa_on_device(
        gs, gsp, h, C, D, z, list(cs), list(ds), t, r, device=CPU)
    assert _ser(direct) == out[0][0]


def test_device_samemsm_byte_identical_to_host_prover():
    gs, A, Zt, Zu, T, U, xs = samemsm_instance()
    out = []
    for prover in device_mode.PROVERS:
        t, r = Transcript(b"sm"), Rand(9)
        p = same_multiscalar.prove(gs, A, Zt, Zu, T, U, list(xs), t, r,
                                   device=CPU, prover=prover)
        out.append((_ser(p), t.get_and_append_challenge(b"probe"),
                    r.get_fr()))
    assert out[0] == out[1]


def test_grand_product_device_branch_byte_identical():
    """The grand-product argument with its inner-product argument on the
    device prover (lazy Gs' by `diag` on the one-row bases)."""
    rand = Rand(5)
    crs = curdleproof.generate_crs(ELL, rand, device=CPU)
    bs = rand.get_frs(ELL)
    r_bs = rand.get_frs(curdleproof.N_BLINDERS)
    p = 1
    for b in bs:
        p = p * b % fh.R
    B = fh.g1_add(fh.g1_msm(crs.gs, bs), fh.g1_msm(crs.hs, r_bs))
    out = []
    for prover in device_mode.PROVERS:
        t, r = Transcript(b"gpa"), Rand(6)
        proof = grand_product.prove(
            grand_product.CRS(crs.gs, crs.hs, crs.h), B, p, list(bs),
            list(r_bs), t, r, device=CPU, prover=prover)
        out.append((_ser(proof), t.get_and_append_challenge(b"probe")))
    assert out[0] == out[1]


def test_blinder_pieces_flag_a_zero_term2():
    """The real flag: rs chosen so that term2 = rs[n-1] - rs[n-2] *
    cs[n-1] / cs[n-2] vanishes (innerproductargument.go:366-371)."""
    rng = Rand(3)
    cs = rng.get_frs(N)
    rs = rng.get_frs(N)
    inv_c = pow(cs[N - 2], -1, fh.R)
    rs[N - 1] = rs[N - 2] * inv_c % fh.R * cs[N - 1] % fh.R
    f = lambda v: device_common.fr_const(v, CPU)
    zero = f([0])
    for last, want_nz in ((rs[N - 1], False), (rs[N - 1] + 1, True)):
        _, term2, nz, _ = device_prover_full._piece_blind2(
            f(rs[:N - 1] + [last]), f(cs), zero, f([inv_c]), zero)
        assert nz.tolist() == [want_nz]
        assert (fr.to_ints(term2) == [0]) is not want_nz


def test_prover_argument_is_validated_and_threaded(monkeypatch):
    rand = Rand(21)
    crs = curdleproof.generate_crs(ELL, rand, device=CPU)
    Rs, Ss = rand.get_g1s(ELL), rand.get_g1s(ELL)
    assert device_mode.DEFAULT_PROVER == "host"
    with pytest.raises(ValueError, match="prover must be one of"):
        curdleproof.prove(crs, Rs, Ss, Rs, Ss, None, [0, 1, 2, 3], 1, [],
                          Rand(1), device=CPU, prover="auto")
    with pytest.raises(ValueError):
        inner_product.prove(inner_product.CRS([], [], None), None, None, 0,
                            [1, 2], [3, 4], Transcript(b"x"), Rand(1),
                            device=CPU, prover="v2")
    # whisk hands its argument down unchanged; the default is "host"
    seen = []

    def fake_prove(*args, prover, **kwargs):
        seen.append(prover)
        raise ValueError("stop here")

    monkeypatch.setattr(curdleproof, "prove", fake_prove)
    pre = [whisk.WhiskTracker.from_points(r, s) for r, s in zip(Rs, Ss)]
    for kwargs in ({}, {"prover": "device"}):
        with pytest.raises(ValueError, match="stop here"):
            whisk.generate_whisk_shuffle_proof(crs, pre, Rand(2), device=CPU,
                                               **kwargs)
    assert seen == ["host", "device"]


def test_fetch_is_one_buffer_split_back():
    a = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    b = torch.tensor([True, False])
    c = torch.arange(200, dtype=torch.uint8)
    out = device_common.fetch([a, b, c])
    assert [o.shape for o in out] == [(3, 4), (2,), (200,)]
    assert out[0].tolist() == a.tolist() and out[1].tolist() == [1, 0]
    assert out[2].tolist() == c.tolist()
