"""The port's whole one-fetch device prove on the CPU (the same chain on
the kernels' plain versions):

  * `curdleproof.prove(..., prover="device")` at ell=4, reached through
    `whisk.generate_whisk_shuffle_proof`, byte-identical to `prover="host"`
    from the same seeds, the Rand left at the same draw, no kernel launched
    on CPU tensors, accepted by the port's and by the JAX package's
    verifier (tests/test_device_prover2.py:81-111 on the port), and the
    Whisk wire bytes and post-trackers the same as the host prover's with
    the spans on;
  * the device prove's spans: one root, `device_prove` holding `upload`,
    `chain` (the six pieces and the folding rounds, no `fetch`), one
    `fetch` and `assemble`; the chain's counter `chain.kernels`; nothing
    recorded with the spans off;
  * a failed deferred check travels in the one fetch and raises ValueError
    after it.

The module's three proves (host, device with spans on, device with a
planted failure and spans off) run once each, in fixtures.

Exact: bytes, no tolerance."""

import io
from types import SimpleNamespace

import pytest
import torch

from go_curdleproofs_tpu.models import curdleproof as jcurdleproof
from go_curdleproofs_tpu.utils.rand import Rand as JRand
from go_curdleproofs_tpu_torch import convert
from go_curdleproofs_tpu_torch.models import (curdleproof, device_common,
                                              device_prover_full, whisk)
from go_curdleproofs_tpu_torch.ops import kernels
from go_curdleproofs_tpu_torch.utils import profiling
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


@pytest.fixture(scope="module")
def proved(instance):
    """prover -> the ell=4 Whisk prove of `_prove`'s seeds on the fixture's
    points as trackers, through whisk.generate_whisk_shuffle_proof: the
    shuffle (Ts, Us, M) that curdleproof.prove was handed and the proof it
    made, the Rand's next draw, the post-trackers and proof bytes, the
    launch counters' change across the call and across `_chain`, and the
    span records. The host prove runs with the spans off, the device prove
    with them on."""
    crs, Rs, Ss = instance
    pre = [whisk.WhiskTracker.from_points(r, s) for r, s in zip(Rs, Ss)]
    out = {}
    for prover in ("host", "device"):
        got = SimpleNamespace(chain_launches=[])
        real_prove, real_chain = curdleproof.prove, device_prover_full._chain

        def prove(crs, Rs, Ss, Ts, Us, M, *args, **kw):
            got.Ts, got.Us, got.M = Ts, Us, M
            got.proof = real_prove(crs, Rs, Ss, Ts, Us, M, *args, **kw)
            return got.proof

        def chain(inp):
            before = device_common.kernel_launches()
            tensors = real_chain(inp)
            got.chain_launches.append(
                device_common.kernel_launches() - before)
            return tensors

        profiling.disable()
        profiling.reset()
        if prover == "device":
            profiling.enable()
        before = device_common.kernel_launches()
        rand = Rand(31)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(curdleproof, "prove", prove)
            mp.setattr(device_prover_full, "_chain", chain)
            try:
                got.post, got.wire = whisk.generate_whisk_shuffle_proof(
                    crs, pre, rand, device=CPU, prover=prover)
            finally:
                profiling.disable()
        got.launched = device_common.kernel_launches() - before
        got.next = rand.get_fr()
        got.records = profiling.drain()
        out[prover] = got
    return out


def test_full_device_prove_byte_identical_and_verified(instance, proved):
    crs, Rs, Ss = instance
    host, dev = proved["host"], proved["device"]
    Ts, Us, M, p_dev = dev.Ts, dev.Us, dev.M, dev.proof
    assert (Ts, Us, M, dev.next) == (host.Ts, host.Us, host.M, host.next)
    assert _ser(p_dev) == _ser(host.proof)
    assert host.launched == dev.launched == 0
    assert curdleproof.verify(p_dev, crs, Rs, Ss, Ts, Us, M, Rand(1),
                              device=CPU)
    jproof = jcurdleproof.Proof.from_reader(io.BytesIO(_ser(p_dev)))
    jcrs = jcurdleproof.CRS(**convert.crs_to_affine(crs))
    assert jcurdleproof.verify(jproof, jcrs, Rs, Ss, Ts, Us, M, JRand(1))


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.id]


def _subtree(recs, root):
    """The records under `root` (parents come before their children)."""
    ids, out = {root.id}, []
    for r in recs:
        if r.parent in ids:
            ids.add(r.id)
            out.append(r)
    return out


def test_a_device_prove_is_one_request_with_its_spans(proved):
    recs = proved["device"].records
    roots = [r for r in recs if r.parent == 0]
    assert [r.name for r in roots] == ["whisk.generate_whisk_shuffle_proof"]
    assert {r.request for r in recs} == {roots[0].request}
    (dp,) = [r for r in recs if r.name == "device_prove"]
    assert next(r for r in recs if r.id == dp.parent).name == \
        "curdleproof.prove"
    inside = [r.name for r in _children(recs, dp)]
    # the host step-1 transcript, the draws, then upload, chain, the one
    # fetch and assemble, in that order
    assert [n for n in inside if n != "transcript"] == [
        "draws", "upload", "chain", "fetch", "assemble"]
    assert inside.count("transcript") == 6
    assert [r.name for r in _subtree(recs, dp)].count("fetch") == 1
    (chain,) = [r for r in recs if r.name == "chain"]
    assert [r.name for r in _children(recs, chain)] == [
        "sameperm_gpa", "blinders", "ipa", "step3_sigma", "samemsm",
        "finalize"]
    rounds = (4 + curdleproof.N_BLINDERS).bit_length() - 1
    for piece, name in (("ipa", "ipa_round"), ("samemsm", "samemsm_round")):
        (p,) = [r for r in recs if r.name == piece]
        assert [r.name for r in _children(recs, p)].count(name) == rounds
    # nothing inside the chain fetches, and the spans nest in time
    for r in _subtree(recs, chain):
        assert r.name != "fetch"
        assert chain.start <= r.start <= r.end <= chain.end
    assert dp.start <= chain.start and chain.end <= dp.end


def test_chain_kernels_counts_the_launches_inside_the_chain(proved,
                                                            monkeypatch):
    """In the prove, `chain.kernels` is the launch counters' change across
    `_chain` (none on the CPU: the plain versions launch nothing) and
    `chain.replays` is 0 (the CPU runs the chain eagerly); through
    device_common.enqueue with made-up launches, the ones inside the chain
    count and the ones before and after do not; with the spans off the
    chain runs and nothing records."""
    dev = proved["device"]
    (chain,) = [r for r in dev.records if r.name == "chain"]
    assert chain.counts == {"chain.kernels": dev.chain_launches[0],
                            "chain.replays": 0}
    assert dev.chain_launches == [dev.launched]

    monkeypatch.setattr(kernels, "launches",
                        dict.fromkeys(kernels.KERNEL_NAMES, 0))

    def fake_chain(n):
        kernels.launches["fr_mont_mul"] += n
        kernels.launches["strobe_challenge32"] += 1
        return n

    profiling.reset()
    profiling.enable()
    try:
        kernels.launches["point_add"] += 5
        assert device_common.enqueue(fake_chain, 3) == 3
        kernels.launches["point_add"] += 2
    finally:
        profiling.disable()
    (rec,) = profiling.drain()
    assert (rec.name, rec.counts) == ("chain", {"chain.kernels": 4})
    assert device_common.enqueue(fake_chain, 1) == 1
    assert profiling.records() == []
    assert device_common.kernel_launches() == 5 + 4 + 2 + 2


def test_whisk_bytes_with_the_spans_on_are_the_host_provers(proved):
    host, dev = proved["host"], proved["device"]
    assert dev.records and not host.records
    assert dev.wire == host.wire
    assert len(dev.wire) == whisk.expected_shuffle_proof_size(4)
    assert [(t.r_g, t.k_r_g) for t in dev.post] == \
        [(t.r_g, t.k_r_g) for t in host.post]


@pytest.fixture(scope="module")
def failed(instance):
    """The device prove with a deferred check that fails on the device
    (the blinder solve's term2 reported zero), spans off: the error it
    raised, the fetches it made, what the span log holds after it."""
    real = device_prover_full._piece_blind2
    got = SimpleNamespace(fetches=[], error=None)

    def degenerate(*args):
        term1, term2, _, c_last = real(*args)
        return term1, term2, torch.zeros(1, dtype=torch.bool), c_last

    def counted(tensors):
        got.fetches.append(len(tensors))
        return device_common.fetch(tensors)

    profiling.disable()
    profiling.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_prover_full, "_piece_blind2", degenerate)
        mp.setattr(device_prover_full, "fetch", counted)
        try:
            _prove(instance, "device")
        except ValueError as e:
            got.error = e
    got.records, got.dropped = profiling.records(), profiling.dropped()
    return got


def test_deferred_sanity_failure_raises_after_the_fetch(failed):
    """A deferred check that fails on the device is read from the one fetch
    and raises ValueError, as the host prover raises at the spot."""
    assert "sanity check failed" in str(failed.error)
    assert len(failed.fetches) == 1


def test_spans_off_record_nothing_in_a_device_prove(failed):
    """With the spans off a device prove, through its chain and its fetch,
    records nothing and counts nothing."""
    assert not profiling.recording()
    assert failed.records == [] and failed.dropped == 0
