"""The port's device-resident prover on the CPU (the same chain on the
kernels' plain versions), around its one-fetch chain:

  * the blinder pieces flag a degenerate solve;
  * the `prover` argument is validated, `whisk` hands it down unchanged,
    and only `whisk.generate_whisk_shuffle_proof` and `curdleproof.prove`
    take it: the sub-arguments' provers are host-orchestrated only;
  * the chain's one fetch is one buffer split back.

The whole one-fetch prove, with its in-chain IPA and same-multiscalar
rounds, is held against the host prover in
tests/test_torch_device_prover_full.py, against the golden bytes in
tests/test_torch_device_prover_golden.py, and its CUDA graph in
tests/test_torch_device_graph.py. Exact: bytes, no tolerance."""

import inspect

import pytest
import torch

from go_curdleproofs_tpu_torch.models import (curdleproof, device_common,
                                              device_mode,
                                              device_prover_full,
                                              grand_product, inner_product,
                                              same_multiscalar,
                                              same_permutation, whisk)
from go_curdleproofs_tpu_torch.ops import fr
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils.rand import Rand

torch.set_num_threads(1)
CPU = torch.device("cpu")
N = 8
ELL = 4


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


# every prove entry point of the port, and whether it takes `prover`
PROVE_ENTRY_POINTS = {
    "whisk.generate_whisk_shuffle_proof":
        (whisk.generate_whisk_shuffle_proof, True),
    "curdleproof.prove": (curdleproof.prove, True),
    "same_permutation.prove": (same_permutation.prove, False),
    "grand_product.prove": (grand_product.prove, False),
    "inner_product.prove": (inner_product.prove, False),
    "same_multiscalar.prove": (same_multiscalar.prove, False),
}


@pytest.mark.parametrize("name", sorted(PROVE_ENTRY_POINTS))
def test_only_whisk_and_curdleproof_take_a_prover(name):
    """The choice of prover is made in one place: `curdleproof.prove`,
    reached from `whisk`. The sub-arguments below it take no `prover`."""
    fn, takes = PROVE_ENTRY_POINTS[name]
    params = inspect.signature(fn).parameters
    assert ("prover" in params) is takes, name
    if takes:
        assert params["prover"].default == device_mode.DEFAULT_PROVER


def test_fetch_is_one_buffer_split_back():
    a = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    b = torch.tensor([True, False])
    c = torch.arange(200, dtype=torch.uint8)
    out = device_common.fetch([a, b, c])
    assert [o.shape for o in out] == [(3, 4), (2,), (200,)]
    assert out[0].tolist() == a.tolist() and out[1].tolist() == [1, 0]
    assert out[2].tolist() == c.tolist()
