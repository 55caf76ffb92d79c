"""The JAX package's batched verifier (go_curdleproofs_tpu/parallel/
batch.py) on the bytes that test_torch_parallel_batch.py gives the port:
the three ell=4 instances of tests/test_torch_parallel_batch.json, honest,
with one proof's last byte flipped, with tracker lists of different
lengths, and with a proof that does not decode. With no mesh its verdicts
are EXPECTED, the port's verdicts there, on the port's CRS; on a 2-device
mesh of the conftest's virtual CPU devices so are those of the two cases
that reach the final MSM (honest, flipped): the other two return before
it, as with no mesh. A file of its own: the JAX package compiles its
programs here."""

import pytest

from go_curdleproofs_tpu.models import curdleproof as jcurdleproof
from go_curdleproofs_tpu.models import whisk as jwhisk
from go_curdleproofs_tpu.parallel import batch as jbatch
from go_curdleproofs_tpu.parallel import msm as jmsm
from go_curdleproofs_tpu.utils.rand import Rand as JRand
from go_curdleproofs_tpu_torch import convert
from test_torch_parallel_batch import (EXPECTED, VERIFY_SEED, cases,
                                       load_fixture, port_cases)


@pytest.fixture(scope="module")
def jax_batches():
    _, _, raw = load_fixture()
    crs, _ = port_cases()
    jcrs = jcurdleproof.CRS(**convert.crs_to_affine(crs))
    insts = [([jwhisk.WhiskTracker(*t) for t in pre],
              [jwhisk.WhiskTracker(*t) for t in post], proof)
             for pre, post, proof in raw]
    return jcrs, cases(insts)


# the cases that reach the final MSM, the only part a mesh shards
MSM_CASES = ("honest", "flipped last byte")


@pytest.mark.parametrize("mesh", [None, 2], ids=["no mesh", "2 devices"])
def test_jax_batch_verdicts(jax_batches, mesh):
    jcrs, batches = jax_batches
    names = MSM_CASES if mesh else tuple(EXPECTED)
    mesh = jmsm.make_mesh(mesh) if mesh else None
    got = {name: jbatch.verify_shuffle_proofs_batch(
        jcrs, batches[name], JRand(VERIFY_SEED), mesh=mesh)
        for name in names}
    assert got == {name: EXPECTED[name] for name in names}
