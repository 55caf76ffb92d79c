"""The port's whole one-fetch device prove on the CPU (the same chain on
the kernels' plain versions):

  * `curdleproof.prove(..., prover="device")` at ell=4 byte-identical to
    `prover="host"` from the same seeds, the Rand left at the same draw, no
    kernel launched on CPU tensors, accepted by the port's and by the JAX
    package's verifier (tests/test_device_prover2.py:81-111 on the port);
  * a failed deferred check travels in the one fetch and raises ValueError
    after it.

Exact: bytes, no tolerance."""

import io

import pytest
import torch

from go_curdleproofs_tpu.models import curdleproof as jcurdleproof
from go_curdleproofs_tpu.utils.rand import Rand as JRand
from go_curdleproofs_tpu_torch import convert
from go_curdleproofs_tpu_torch.models import (curdleproof, device_common,
                                              device_prover_full)
from go_curdleproofs_tpu_torch.ops import kernels
from go_curdleproofs_tpu_torch.utils.rand import Rand

torch.set_num_threads(1)
CPU = torch.device("cpu")
ELL = 4


def _ser(p) -> bytes:
    b = io.BytesIO()
    p.serialize(b)
    return b.getvalue()


@pytest.fixture(scope="module")
def instance():
    rand = Rand(21)
    crs = curdleproof.generate_crs(ELL, rand, device=CPU)
    Rs, Ss = rand.get_g1s(ELL), rand.get_g1s(ELL)
    return crs, Rs, Ss


def _prove(instance, prover, seed=31):
    crs, Rs, Ss = instance
    r = Rand(seed)
    perm = r.generate_permutation(ELL)
    k = r.get_fr()
    Ts, Us, M, rs_m = curdleproof.shuffle_permute_commit(
        crs.gs, crs.hs, Rs, Ss, perm, k, r, device=CPU)
    proof = curdleproof.prove(crs, Rs, Ss, Ts, Us, M, perm, k, rs_m, r,
                              device=CPU, prover=prover)
    return Ts, Us, M, proof, r.get_fr()


def test_full_device_prove_byte_identical_and_verified(instance):
    crs, Rs, Ss = instance
    kernels.reset_launches()
    Ts, Us, M, p_host, next_host = _prove(instance, "host")
    Ts2, Us2, M2, p_dev, next_dev = _prove(instance, "device")
    assert (Ts2, Us2, M2, next_dev) == (Ts, Us, M, next_host)
    assert _ser(p_dev) == _ser(p_host)
    assert kernels.launches == {n: 0 for n in kernels.KERNEL_NAMES}
    assert curdleproof.verify(p_dev, crs, Rs, Ss, Ts, Us, M, Rand(1),
                              device=CPU)
    jproof = jcurdleproof.Proof.from_reader(io.BytesIO(_ser(p_dev)))
    jcrs = jcurdleproof.CRS(**convert.crs_to_affine(crs))
    assert jcurdleproof.verify(jproof, jcrs, Rs, Ss, Ts, Us, M, JRand(1))


def test_deferred_sanity_failure_raises_after_the_fetch(instance,
                                                        monkeypatch):
    """A deferred check that fails on the device (here: the blinder solve's
    term2 reported zero) is read from the one fetch and raises ValueError,
    as the host prover raises at the spot."""
    real = device_prover_full._piece_blind2
    fetches = []

    def degenerate(*args):
        term1, term2, _, c_last = real(*args)
        return term1, term2, torch.zeros(1, dtype=torch.bool), c_last

    def counted(tensors):
        fetches.append(len(tensors))
        return device_common.fetch(tensors)

    monkeypatch.setattr(device_prover_full, "_piece_blind2", degenerate)
    monkeypatch.setattr(device_prover_full, "fetch", counted)
    with pytest.raises(ValueError, match="sanity check failed"):
        _prove(instance, "device")
    assert len(fetches) == 1
