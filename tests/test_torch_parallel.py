"""The sharded MSM of the port (go_curdleproofs_tpu_torch/parallel/msm.py)
on the CPU: 2 and 4 gloo ranks, each a process spawned by
parallel.ranks.spawn_ranks (a join timeout fails the test instead of
hanging it), held exactly against the host oracle fh.g1_msm and the JAX
package's parallel.msm.sharded_msm on the conftest's virtual CPU devices.
An empty shard, a one-rank group in this process, and the shard bounds.
The batched verifier on 4 ranks here, with no group and on 2 ranks in
test_torch_parallel_batch.py, the JAX package's verdicts in
test_torch_parallel_jax.py."""

import random
import tempfile
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from go_curdleproofs_tpu.parallel import msm as jmsm
from go_curdleproofs_tpu_torch.parallel import msm as pmsm
from go_curdleproofs_tpu_torch.parallel import ranks
from go_curdleproofs_tpu_torch.utils import field_host as fh
from test_torch_parallel_batch import EXPECTED, port_verdicts

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _points_and_scalars(seed: int, n: int = 14):
    """n random points plus infinity plus G, with random scalars."""
    rng = random.Random(seed)
    pts = [fh.g1_mul(fh.G1_GEN, rng.randrange(fh.R)) for _ in range(n)] \
        + [None, fh.G1_GEN]
    return pts, [rng.randrange(fh.R) for _ in pts]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_msm_matches_oracle_and_jax(world):
    pts, sc = _points_and_scalars(5 + world)
    want = fh.g1_msm(pts, sc)
    got = ranks.spawn_ranks(pmsm.sharded_msm, world, backend="gloo",
                            args=(pts, sc))
    assert got == [want] * world
    assert jmsm.sharded_msm(pts, sc, jmsm.make_mesh(world)) == want
    assert pmsm.sharded_msm(pts, sc, device=CPU) == want


def test_sharded_msm_with_an_empty_shard():
    """3 points over 4 ranks: the last rank's shard is empty and it still
    enters the all_gather with an infinity row."""
    pts, sc = _points_and_scalars(11, n=1)
    assert pmsm._shard(len(pts), 3, 4) == slice(3, 3)
    got = ranks.spawn_ranks(pmsm.sharded_msm, 4, backend="gloo",
                            args=(pts, sc))
    assert got == [fh.g1_msm(pts, sc)] * 4


@pytest.mark.parametrize("n,world", [(0, 2), (1, 4), (3, 4), (16, 4),
                                     (17, 4), (16, 2), (5, 1)])
def test_shards_are_contiguous_and_cover_the_list(n, world):
    parts = [pmsm._shard(n, r, world) for r in range(world)]
    assert [i for p in parts for i in range(p.start, p.stop)] \
        == list(range(n))
    assert all(p.stop - p.start <= -(-n // world) for p in parts)


def test_one_rank_group_in_this_process():
    """The one-rank group chip_smoke.py makes on a card, here over gloo:
    make_group names the default group, sharded_msm gathers one row."""
    pts, sc = _points_and_scalars(13, n=6)
    with tempfile.TemporaryDirectory() as tmp:
        group = pmsm.init_file_group(str(Path(tmp) / "store"), rank=0,
                                     world_size=1, backend="gloo")
        try:
            assert pmsm.make_group() is group
            assert pmsm.make_group([0]) is group
            got = pmsm.sharded_msm(pts, sc, device=CPU, group=group)
        finally:
            dist.destroy_process_group()
    assert got == fh.g1_msm(pts, sc)


def test_length_mismatch_raises():
    with pytest.raises(ValueError):
        pmsm.sharded_msm([fh.G1_GEN], [1, 2], device=CPU)


def test_batch_verdicts_on_four_ranks():
    """The honest batch and the one with a flipped byte (both reach the
    final MSM) on 4 gloo ranks: the verdicts of every rank are the
    port's with no group and the JAX package's."""
    names = ("honest", "flipped last byte")
    assert port_verdicts(4, names) == {n: EXPECTED[n] for n in names}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_one_rank_nccl_group(cuda_device):
    """On the card: a one-rank NCCL group from a FileStore, the sharded MSM
    against the host oracle and the ell=4 batches' verdicts."""
    from test_torch_parallel_batch import cases, load_fixture
    from go_curdleproofs_tpu_torch.models import curdleproof, whisk
    from go_curdleproofs_tpu_torch.parallel import batch
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    pts, sc = _points_and_scalars(17, n=40)
    ell, crs_seed, raw = load_fixture()
    torch.cuda.set_device(cuda_device)
    with tempfile.TemporaryDirectory() as tmp:
        group = pmsm.init_file_group(str(Path(tmp) / "store"), rank=0,
                                     world_size=1, backend="nccl")
        try:
            assert pmsm.sharded_msm(pts, sc, device=cuda_device,
                                    group=group) == fh.g1_msm(pts, sc)
            crs = curdleproof.generate_crs(ell, Rand(crs_seed),
                                           device=cuda_device)
            insts = [([whisk.WhiskTracker(*t) for t in pre],
                      [whisk.WhiskTracker(*t) for t in post], proof)
                     for pre, post, proof in raw]
            got = {name: batch.verify_shuffle_proofs_batch(
                crs, b, Rand(5), device=cuda_device, group=group)
                for name, b in cases(insts).items()}
        finally:
            dist.destroy_process_group()
    assert got == EXPECTED
