"""The device prover's chain as one CUDA graph
(models/device_prover_full.py `_ChainGraph`).

On the CPU:

  * `halflimb.device_cache` keeps what it returns inside a `holding()`
    block, cache hits too, in every open block, and a value so kept
    outlives a clear of the cache;
  * `_remap` / `_tensors` reach every tensor that `_chain` reads: the chain
    on a copy of a prove's inputs gives that prove's fetched bytes;
  * once warm, the chain uploads nothing (no `halflimb.upload` call), so
    that a capture holds no host-to-device copy of pageable memory; an
    upload to a CUDA device while a graph is captured raises
    `halflimb.UploadInCapture` before any copy;
  * a capture keeps as the replay's buffers the tensors the chain read as
    it started (not those it moved on to); a capture that meets such an
    upload keeps nothing and takes back the launches it counted, and the
    prove runs the chain eagerly;
  * `kernels.traced_launches` counts each hand-written kernel by its CUDA
    function's name in a profiler's device events, and nothing else.

On a CUDA card (`-m cuda`; this file imports nothing of JAX, so on the
card's host: `python -m pytest --noconftest -o addopts= -m cuda
tests/test_torch_device_graph.py`), at ELL=124:

  * six consecutive Whisk proves, each on the previous one's
    post-trackers: byte-identical to the host prover's; the first runs the
    chain eagerly, the second captures, the rest replay (`chain.replays`
    0, 1, 1, ...); `chain.kernels` the same on every prove; each kernel's
    wrapper launches across the chain the same in the eager run and the
    capture, none in a replay, and a seventh prove, a replay under
    torch.profiler, running on the card each kernel, less its wrapper
    launches outside the chain, as often as the eager chain launched it; each prove's fetched arrays and end positions equal
    to what the eager `_chain` gives on a copy of its inputs;
  * a deferred sanity failure captured into the graph raises ValueError
    after a replay;
  * a graph replays right after the device constants' caches are cleared
    and their memory is handed out again;
  * with the caches cleared between the eager prove and the capture, the
    capture gives way to an eager chain, and the next prove captures; a
    prove inside `eager_chain()` runs eagerly beside a captured graph.

Exact: bytes, no tolerance."""

import contextlib
import gc
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from go_curdleproofs_tpu_torch.models import (curdleproof, device_common,
                                              device_prover_full, whisk)
from go_curdleproofs_tpu_torch.ops import (compress_dev, curve, halflimb,
                                           kernels, strobe_dev)
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils import profiling
from go_curdleproofs_tpu_torch.utils.rand import Rand

torch.set_num_threads(1)
CPU = torch.device("cpu")


# -- the CPU ------------------------------------------------------------------

def test_device_cache_holds_what_it_returns_inside_a_holding_block():
    made = []

    @halflimb.device_cache(maxsize=2)
    def const(v, device):
        made.append(v)
        return torch.full((3,), v, device=device)

    a = const(1, CPU)
    with halflimb.holding() as outer:
        assert const(1, CPU) is a                   # a hit is held too
        with halflimb.holding() as inner:
            b = const(2, CPU)
        c = const(3, CPU)
    const(4, CPU)
    assert made == [1, 2, 3, 4]
    assert [id(t) for t in outer] == [id(a), id(b), id(c)]
    assert [id(t) for t in inner] == [id(b)]
    assert halflimb._holding == []
    const.cache_clear()
    assert const.cache_info().currsize == 0
    assert torch.equal(outer[1], torch.full((3,), 2))
    assert const(2, CPU) is not b and made[-1] == 2


ELL = 4


@pytest.fixture(scope="module")
def chain_run():
    """One ell=4 device prove on the CPU with `_run_chain` wrapped: a copy
    of the chain's inputs taken before it ran, and what it fetched."""
    rand = Rand(21)
    crs = curdleproof.generate_crs(ELL, rand, device=CPU)
    pre = [whisk.WhiskTracker.from_points(r, s)
           for r, s in zip(rand.get_g1s(ELL), rand.get_g1s(ELL))]
    real = device_prover_full._run_chain
    got = SimpleNamespace()

    def run(inp):
        got.entry = device_prover_full._graph_entry(inp)
        got.copy = device_prover_full._remap(inp, torch.clone)
        got.out = real(inp)
        got.end = (inp.ts.pos, inp.ts.pos_begin)
        return got.out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_prover_full, "_run_chain", run)
        whisk.generate_whisk_shuffle_proof(crs, pre, Rand(31), device=CPU,
                                           prover="device")
    return got


def test_the_cpu_builds_no_graph(chain_run):
    assert chain_run.entry is None
    assert not any(key[0].type == "cpu" for key in device_prover_full._graphs)


def test_the_chain_on_a_copy_of_its_inputs_fetches_the_same_bytes(chain_run):
    """`_remap` copies every tensor `_tensors` lists, and the chain reads
    nothing else: a second chain on the copy, with the constants' caches
    warm, uploads nothing and fetches the prove's arrays, and ends at the
    same transcript positions."""
    src = device_prover_full._tensors(chain_run.copy)
    copy = device_prover_full._remap(chain_run.copy, torch.clone)
    dst = device_prover_full._tensors(copy)
    assert len(src) == len(dst) == 6 * 3 + 6 + len(copy.scalars) + 1
    assert all(a is not b and torch.equal(a, b) for a, b in zip(src, dst))

    uploads = []
    real = halflimb.upload

    def counted(*args, **kwargs):
        uploads.append(args[1:])
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(halflimb, "upload", counted)
        out = device_common.fetch(device_prover_full._chain(copy))
    assert uploads == []
    assert (copy.ts.pos, copy.ts.pos_begin) == chain_run.end
    assert len(out) == len(chain_run.out)
    assert all(np.array_equal(a, b) for a, b in zip(out, chain_run.out))


def test_an_upload_while_a_graph_is_captured_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(halflimb.UploadInCapture):
        halflimb.upload([1, 2], torch.uint8, torch.device("cuda"))
    # the CPU never captures
    assert halflimb.upload([1, 2], torch.uint8, CPU).tolist() == [1, 2]


def test_a_capture_that_meets_an_upload_gives_way_to_the_eager_chain(
        chain_run, monkeypatch):
    """The capture's launches counted and then an upload, as where a
    constant has left its cache: the prove fetches the eager chain's
    bytes, its chain span counts no replay and none of the capture's
    launches, and the entry keeps no graph."""
    capturing = [False]
    real = device_prover_full._chain

    def chain(inp):
        if capturing[0]:
            kernels.launches["mont_mul"] += 3
            halflimb.upload([1], torch.uint8, torch.device("cuda"))
        return real(inp)

    @contextlib.contextmanager
    def graph(g):
        capturing[0] = True
        try:
            yield
        finally:
            capturing[0] = False

    entry = device_prover_full._ChainGraph()
    entry.warm = True
    monkeypatch.setattr(device_prover_full, "_chain", chain)
    monkeypatch.setattr(device_prover_full, "_graph_entry", lambda inp: entry)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    inp = device_prover_full._remap(chain_run.copy, torch.clone)
    before = dict(kernels.launches)
    profiling.reset()
    profiling.enable()
    try:
        out = device_prover_full._run_chain(inp)
    finally:
        profiling.disable()
    assert _chain_counts() == [{"chain.replays": 0, "chain.kernels": 0}]
    assert kernels.launches == before
    assert entry.graph is None and entry.warm
    assert (inp.ts.pos, inp.ts.pos_begin) == chain_run.end
    assert all(np.array_equal(a, b) for a, b in zip(out, chain_run.out))


def test_a_capture_keeps_as_buffers_the_tensors_the_chain_starts_from(
        chain_run, monkeypatch):
    """A capture (the graph standing in as one that runs the chain as it is
    captured) keeps as the replay's buffers the very tensors the chain read
    as it started, though the chain moves its transcript state on, and
    the constants it took from the caches."""
    started = []
    real = device_prover_full._chain

    def chain(inp):
        started.append(device_prover_full._tensors(inp))
        return real(inp)

    monkeypatch.setattr(device_prover_full, "_chain", chain)
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: SimpleNamespace(replay=lambda: None))
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    entry = device_prover_full._ChainGraph()
    assert entry.capture(device_prover_full._remap(chain_run.copy,
                                                   torch.clone))
    (first,) = started
    assert len(entry.buffers) == len(first)
    assert all(a is b for a, b in zip(entry.buffers, first))
    assert entry.consts and entry.end == chain_run.end
    out = device_common.fetch(entry.outputs)
    assert all(np.array_equal(a, b) for a, b in zip(out, chain_run.out))


def test_traced_launches_counts_each_kernel_by_its_function_name():
    cuda, cpu = (torch.autograd.DeviceType.CUDA,
                 torch.autograd.DeviceType.CPU)
    events = [SimpleNamespace(key=k, count=n, device_type=d) for k, n, d in (
        ("void mont_mul_kernel<2, true>(unsigned int const*, unsigned int "
         "const*, unsigned int*, long long, int)", 5, cuda),
        ("void mont_mul_kernel<4, false>(unsigned int const*, ...)", 2, cuda),
        ("fr_mont_mul_kernel(Fr const*, Fr const*, Fr*, long long, int, "
         "int)", 7, cuda),
        ("pow_fixed_kernel(Fp const*, Fp*, int, Exponent, int)", 1, cuda),
        ("fr_pow_fixed_kernel(Fr const*, Fr*, long long, FrExponent, int)",
         4, cuda),
        ("msm_select_reduce_kernel(Fp const*, ...)", 3, cuda),
        ("msm_finish_kernel(Fp const*, ...)", 3, cuda),
        ("void strobe_challenge32_kernel<true>(unsigned char*, ...)", 6,
         cuda),
        ("Memcpy DtoD (Device -> Device)", 9, cuda),
        ("void at::native::vectorized_elementwise_kernel<4, ...>", 8, cuda),
        ("point_add_kernel", 11, cpu),
        ("cudaLaunchKernel", 40, cpu))]
    got = kernels.traced_launches(events)
    assert got == dict(dict.fromkeys(kernels.KERNEL_NAMES, 0), mont_mul=7,
                       fr_mont_mul=7, pow_fixed=1, fr_pow_fixed=4,
                       msm_select_reduce=3, strobe_challenge32=6)


# -- the card -------------------------------------------------------------------

WELL = 124
SEEDS = (2 ** 33 + 13, 7, 2 ** 31 + 5, 99, 123456789, 4242)


@pytest.fixture(scope="module")
def card():
    """ELL=124 on the card: the CRS and a first tracker set from seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    crs = curdleproof.generate_crs(WELL, Rand(5), device=dev)
    rand = Rand(6)
    rs, k = rand.get_frs(WELL), rand.get_fr()
    r_g = curve.batch_scalar_mul([fh.G1_GEN] * WELL, rs, device=dev)
    kr_g = curve.batch_scalar_mul(r_g, [k] * WELL, device=dev)
    pre = [whisk.WhiskTracker.from_points(a, b) for a, b in zip(r_g, kr_g)]
    return dev, crs, pre


@pytest.fixture
def fresh_graphs(monkeypatch):
    """No graph captured before the test, and none it captures kept."""
    monkeypatch.setattr(device_prover_full, "_graphs", {})


def _prove(card, pre, seed, prover="device"):
    dev, crs, _ = card
    return whisk.generate_whisk_shuffle_proof(crs, pre, Rand(seed),
                                              device=dev, prover=prover)


def _chain_counts():
    return [r.counts for r in profiling.drain() if r.name == "chain"]


def _trackers(post):
    return [(t.r_g, t.k_r_g) for t in post]


@pytest.mark.cuda
def test_cuda_replays_are_the_eager_chains_and_the_host_provers_bytes(
        card, fresh_graphs, monkeypatch):
    real = device_prover_full._run_chain
    runs = []

    def run(inp):
        copy = device_prover_full._remap(inp, torch.clone)
        before = dict(kernels.launches)
        out = real(inp)
        launched.append({k: n - before[k]
                         for k, n in kernels.launches.items()})
        runs.append((copy, out, (inp.ts.pos, inp.ts.pos_begin)))
        return out

    monkeypatch.setattr(device_prover_full, "_run_chain", run)
    pre, launched, counts = card[2], [], []
    profiling.reset()
    for seed in SEEDS:
        profiling.enable()
        try:
            post, proof = _prove(card, pre, seed)
        finally:
            profiling.disable()
        counts += _chain_counts()
        post_h, proof_h = _prove(card, pre, seed, "host")
        assert proof == proof_h, seed
        assert _trackers(post) == _trackers(post_h), seed
        pre = post                      # the next request's new trackers

    # a seventh prove, a replay, and what it runs on the card
    before = dict(kernels.launches)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        post, proof = _prove(card, pre, SEEDS[0] + 1)
        torch.cuda.synchronize()
    counts += _chain_counts()
    # the wrappers' launches, all outside the chain in a replay
    outside = {k: n - before[k] for k, n in kernels.launches.items()}
    assert proof == _prove(card, pre, SEEDS[0] + 1, "host")[1]

    assert [c["chain.replays"] for c in counts] == [0] + [1] * 6
    assert len({c["chain.kernels"] for c in counts}) == 1
    assert counts[0]["chain.kernels"] > 800
    # the wrappers launch each kernel as often in the chain's eager run as
    # in its capture, and never in a replay, which runs the same kernels
    assert launched[1] == launched[0]
    assert all(not any(n.values()) for n in launched[2:])
    on_card = kernels.traced_launches(prof.key_averages())
    assert {k: n - outside[k] for k, n in on_card.items()} == launched[0]
    (entry,) = device_prover_full._graphs.values()
    assert entry.launches == launched[0]
    assert sum(entry.launches.values()) == counts[0]["chain.kernels"]

    for copy, out, end in runs:
        eager = device_common.fetch(device_prover_full._chain(copy))
        assert (copy.ts.pos, copy.ts.pos_begin) == end
        assert all(np.array_equal(a, b) for a, b in zip(eager, out))


@pytest.mark.cuda
def test_cuda_deferred_sanity_failure_raises_after_a_replay(
        card, fresh_graphs, monkeypatch):
    real = device_prover_full._piece_blind2

    def degenerate(*args):
        term1, term2, nz, c_last = real(*args)
        return term1, term2, torch.zeros_like(nz), c_last

    monkeypatch.setattr(device_prover_full, "_piece_blind2", degenerate)
    profiling.reset()
    profiling.enable()
    try:
        for seed in SEEDS[:3]:
            with pytest.raises(ValueError, match="sanity check failed"):
                _prove(card, card[2], seed)
    finally:
        profiling.disable()
    assert [c["chain.replays"] for c in _chain_counts()] == [0, 1, 1]


@pytest.mark.cuda
def test_cuda_a_graph_outlives_a_clear_of_the_constant_caches(
        card, fresh_graphs):
    pre = card[2]
    for seed in SEEDS[:2]:              # eager, then the capture
        _prove(card, pre, seed)
    (entry,) = device_prover_full._graphs.values()
    assert entry.graph is not None and entry.consts
    for cache in (strobe_dev._const, strobe_dev._rows_layout,
                  strobe_dev._prefix_layout, kernels._label_on,
                  compress_dev._inf_row, curve._rows_index,
                  halflimb.const_limbs, halflimb._arange, halflimb._diag):
        cache.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    # hand the freed blocks out again, filled with junk
    junk = [torch.full((n,), 0xA5, dtype=torch.uint8, device=card[0])
            for n in range(1, 4097, 3)]
    profiling.reset()
    profiling.enable()
    try:
        post, proof = _prove(card, pre, SEEDS[2])
    finally:
        profiling.disable()
    assert [c["chain.replays"] for c in _chain_counts()] == [1]
    post_h, proof_h = _prove(card, pre, SEEDS[2], "host")
    assert proof == proof_h and _trackers(post) == _trackers(post_h)
    del junk


@pytest.mark.cuda
def test_cuda_caches_cleared_before_the_capture_give_way_to_the_eager_chain(
        card, fresh_graphs):
    pre = card[2]
    _prove(card, pre, SEEDS[0])                     # eager
    for cache in (strobe_dev._const, strobe_dev._rows_layout,
                  strobe_dev._prefix_layout, kernels._label_on):
        cache.cache_clear()
    profiling.reset()
    profiling.enable()
    try:
        # the capture meets an upload: eager; then the capture; a replay;
        # and a prove inside eager_chain() beside the graph
        proofs = [_prove(card, pre, seed) for seed in SEEDS[1:4]]
        with device_prover_full.eager_chain():
            proofs.append(_prove(card, pre, SEEDS[4]))
    finally:
        profiling.disable()
    assert [c["chain.replays"] for c in _chain_counts()] == [0, 1, 1, 0]
    (entry,) = device_prover_full._graphs.values()
    assert entry.graph is not None
    for seed, (post, proof) in zip(SEEDS[1:5], proofs):
        post_h, proof_h = _prove(card, pre, seed, "host")
        assert proof == proof_h and _trackers(post) == _trackers(post_h)
