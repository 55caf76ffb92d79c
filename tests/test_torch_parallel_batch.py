"""Batched verification on the port (go_curdleproofs_tpu_torch/parallel/
batch.py) on the CPU, with no group and on 2 gloo ranks, each rank a
process spawned by parallel.ranks.spawn_ranks (a join timeout fails the
test instead of hanging it).

The input is tests/test_torch_parallel_batch.json: three ell=4 Whisk
shuffle instances from the port's host prover, which
`python3 -m tests.test_torch_parallel_batch` writes again from their seeds
(~70 s: a prove takes ~20 s on the CPU's plain versions, so the tests read
the bytes instead of proving). Four batches of them: honest, one proof's
last byte flipped, one instance's tracker lists of different lengths, and
one proof whose first point does not decode. The verdicts are EXPECTED
here; test_torch_parallel_jax.py holds the JAX package's
verify_shuffle_proofs_batch to the same verdicts on the same bytes, with no
mesh and on a 2-device mesh, and test_torch_parallel.py the port's on 4
ranks. The rank runs of the four cases are started together."""

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from go_curdleproofs_tpu_torch.models import curdleproof, whisk
from go_curdleproofs_tpu_torch.parallel import batch, ranks
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils.rand import Rand

torch.set_num_threads(1)
CPU = torch.device("cpu")
FIXTURE = Path(__file__).resolve().with_suffix(".json")
# the fixture's CRS from Rand(CRS_SEED), instance i's trackers from
# Rand(TRACKER_SEED + i), its proof from Rand(PROVE_SEED + i)
ELL, CRS_SEED, TRACKER_SEED, PROVE_SEED, COUNT = 4, 77, 300, 100, 3
EXPECTED = {"honest": True, "flipped last byte": False,
            "length mismatch": False, "does not decode": False}
VERIFY_SEED = 5


def load_fixture():
    """(ell, crs seed, [(pre, post, proof)] as bytes)."""
    fx = json.loads(FIXTURE.read_text())

    def trackers(pairs):
        return [(bytes.fromhex(a), bytes.fromhex(b)) for a, b in pairs]

    return fx["ell"], fx["crs_seed"], [
        (trackers(i["pre"]), trackers(i["post"]), bytes.fromhex(i["proof"]))
        for i in fx["instances"]]


def cases(instances):
    """{case: [(pre, post, proof)]} over any tracker type."""
    flipped = bytearray(instances[1][2])
    flipped[-1] ^= 1
    undecodable = bytearray(instances[2][2])
    undecodable[0] = 0x20                       # no valid flag bits
    pre0, post0, proof0 = instances[0]
    return {
        "honest": list(instances),
        "flipped last byte": [instances[0], (*instances[1][:2],
                                             bytes(flipped)), instances[2]],
        "length mismatch": [(pre0, post0[:-1], proof0)] + instances[1:],
        "does not decode": instances[:2] + [(*instances[2][:2],
                                             bytes(undecodable))],
    }


def port_cases():
    ell, crs_seed, raw = load_fixture()
    crs = curdleproof.generate_crs(ell, Rand(crs_seed), device=CPU)
    insts = [([whisk.WhiskTracker(*t) for t in pre],
              [whisk.WhiskTracker(*t) for t in post], proof)
             for pre, post, proof in raw]
    return crs, cases(insts)


def port_verdicts(world, names=tuple(EXPECTED)):
    """{case: verdict} of the port: in this process with no group, or on
    `world` gloo ranks (every rank's verdict, which must agree), the
    cases' rank runs started together."""
    crs, batches = port_cases()
    if world is None:
        return {n: batch.verify_shuffle_proofs_batch(
            crs, batches[n], Rand(VERIFY_SEED), device=CPU) for n in names}
    with ThreadPoolExecutor(len(names)) as pool:
        runs = {n: pool.submit(ranks.spawn_ranks,
                               batch.verify_shuffle_proofs_batch, world,
                               backend="gloo",
                               args=(crs, batches[n], Rand(VERIFY_SEED)),
                               timeout_s=240.0)
                for n in names}
        got = {n: r.result() for n, r in runs.items()}
    assert all(len(set(v)) == 1 for v in got.values()), got
    return {n: v[0] for n, v in got.items()}


def test_fixture_is_three_ell4_instances():
    ell, _, raw = load_fixture()
    assert ell == 4 and len(raw) == 3
    assert len({proof for _, _, proof in raw}) == 3
    assert all(len(pre) == len(post) == ell for pre, post, _ in raw)


@pytest.mark.parametrize("world", [None, 2], ids=["no group", "2 ranks"])
def test_batch_verdicts(world):
    assert port_verdicts(world) == EXPECTED


def write_fixture() -> None:
    """The fixture from its seeds, through the port's host prover."""
    crs = curdleproof.generate_crs(ELL, Rand(CRS_SEED), device=CPU)
    instances = []
    for i in range(COUNT):
        rand = Rand(TRACKER_SEED + i)
        pre = []
        for _ in range(ELL):
            r, k = rand.get_fr(), rand.get_fr()
            pre.append(whisk.WhiskTracker.from_points(
                fh.g1_mul(fh.G1_GEN, r), fh.g1_mul(fh.G1_GEN, r * k % fh.R)))
        post, proof = whisk.generate_whisk_shuffle_proof(
            crs, pre, Rand(PROVE_SEED + i), device=CPU)
        instances.append(dict(
            pre=[[t.r_g.hex(), t.k_r_g.hex()] for t in pre],
            post=[[t.r_g.hex(), t.k_r_g.hex()] for t in post],
            proof=proof.hex()))
    FIXTURE.write_text(json.dumps(dict(
        ell=ELL, crs_seed=CRS_SEED, tracker_seed=TRACKER_SEED,
        prove_seed=PROVE_SEED, instances=instances), indent=1) + "\n")


if __name__ == "__main__":
    write_fixture()
