"""The port's functional device STROBE (ops/strobe_dev.py: `SState` and the
functions on it) against the JAX package's dynamic engine (the three cases
of tests/test_device_stack.py:37-80), against the port's host Strobe128,
Merlin and Transcript, byte for byte with positions, and for purity: no
call writes into the state it was given."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_curdleproofs_tpu.ops import strobe_dev as jsd
from go_curdleproofs_tpu_torch.ops import strobe_dev as sd
from go_curdleproofs_tpu_torch.utils.merlin import MerlinTranscript
from go_curdleproofs_tpu_torch.utils.strobe import Strobe128
from go_curdleproofs_tpu_torch.utils.transcript import Transcript

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _dev(b: bytes) -> torch.Tensor:
    return torch.tensor(list(b), dtype=torch.uint8)


def _jdev(b: bytes):
    return jnp.asarray(np.frombuffer(b, np.uint8).astype(np.int32))


def _bytes(t) -> bytes:
    return bytes(np.asarray(t).astype(np.uint8).tolist())


def _same(s: sd.SState, h: Strobe128) -> bool:
    return (_bytes(s.st.cpu()) == bytes(h.state) and s.pos == h.pos
            and s.pos_begin == h.pos_begin)


def _pure(fn, s: sd.SState, *args):
    """fn(s, *args), checking that s's tensor is left as it was."""
    before = s.st.clone()
    out = fn(s, *args)
    assert torch.equal(s.st, before)
    return out


def test_random_op_sequence_matches_jax_and_host():
    rng = random.Random(0)
    h = Strobe128(b"test proto")
    s = sd.from_host(h, device=CPU)
    j = jsd.from_host(h)
    f_meta = jax.jit(lambda s, x: jsd.meta_ad(s, x, False))
    f_ad = jax.jit(lambda s, x: jsd.ad(s, x, False))
    f_prf = jax.jit(lambda s: jsd.prf(s, 32))
    for _ in range(12):
        data = bytes(rng.randrange(256)
                     for _ in range(rng.choice([1, 48, 52, 120])))
        kind = rng.choice(["meta", "ad", "prf"])
        if kind == "meta":
            h.meta_ad(data, False)
            s = _pure(sd.meta_ad, s, data, False)
            j = f_meta(j, _jdev(data))
        elif kind == "ad":
            h.ad(data, False)
            s = _pure(sd.ad, s, _dev(data), False)
            j = f_ad(j, _jdev(data))
        else:
            want = h.prf(32, False)
            s, out = _pure(sd.prf, s, 32)
            j, jout = f_prf(j)
            assert _bytes(out) == _bytes(jout) == want
        assert _same(s, h)
        assert _bytes(s.st) == _bytes(j.st)
        assert (s.pos, s.pos_begin) == (int(j.pos), int(j.pos_begin))


def test_forty_ops_across_the_rate_match_host():
    """40 meta-AD / AD / PRF operations of 1, 48, 52, 120 and 200 bytes
    (200 crosses the rate in one operation) from the host's state."""
    rng = random.Random(40)
    h = Strobe128(b"forty")
    s = sd.from_host(h, device=CPU)
    for _ in range(40):
        n = rng.choice([1, 48, 52, 120, 200])
        data = bytes(rng.randrange(256) for _ in range(n))
        kind = rng.choice(["meta", "ad", "prf"])
        if kind == "meta":
            h.meta_ad(data, False)
            s = _pure(sd.meta_ad, s, _dev(data), False)
        elif kind == "ad":
            h.ad(data, False)
            s = _pure(sd.ad, s, data, False)
        else:
            want = h.prf(n, False)
            s, out = _pure(sd.prf, s, n)
            assert _bytes(out) == want
        assert _same(s, h)
    back = sd.to_host(s, None, h.cur_flags)
    assert bytes(back.state) == bytes(h.state)
    assert (back.pos, back.pos_begin, back.cur_flags) == \
        (h.pos, h.pos_begin, h.cur_flags)


@pytest.mark.parametrize("start", [0, 1, 100, 163, 164, 165])
def test_absorb_and_squeeze_from_every_kind_of_start(start):
    """A continued AD (more=True: a bare absorb) and a squeeze that end
    before, at and beyond the end of the rate."""
    for k in (1, 2, 166 - start, 167 - start, 170):
        h = Strobe128(b"starts")
        h.ad(b"", False)
        h._absorb(bytes(range((start - h.pos) % 166)))
        s = sd.from_host(h, device=CPU)
        assert s.pos == start
        data = bytes((7 * i + start) & 255 for i in range(k))
        h.ad(data, True)
        s = _pure(sd.ad, s, data, True)
        assert _same(s, h), (start, k)
        want = h._squeeze(k)
        s, out = _pure(sd.squeeze, s, k)
        assert _bytes(out) == want and _same(s, h), (start, k)
    s, out = sd.squeeze(s, 0)
    assert out.shape == (0,) and _same(s, h)
    assert sd.absorb(s, b"") is s


def test_merlin_vector_matches_jax_and_host():
    mh = MerlinTranscript(b"test protocol")
    s = sd.from_host(mh.strobe, device=CPU)
    j = jsd.from_host(mh.strobe)
    mh.append_message(b"some label", b"some data")
    s = _pure(sd.append_message, s, b"some label", _dev(b"some data"))
    j = jax.jit(lambda s, m: jsd.append_message(s, b"some label", m))(
        j, _jdev(b"some data"))
    want = mh.challenge_bytes(b"challenge", 32)
    s, out = _pure(sd.challenge_bytes, s, b"challenge", 32)
    j, jout = jax.jit(lambda s: jsd.challenge_bytes(s, b"challenge", 32))(j)
    assert _bytes(out) == _bytes(jout) == want
    assert want.hex() == ("d5a21972d0d5fe320c0d263fac7fffb8"
                          "145aa640af6e9bca177c03c7efcf0615")
    assert _same(s, mh.strobe)


def test_challenge_rejection_matches_jax_and_host():
    """6 chained challenges under one label: the values, and the state
    after them, as the host transcript and the JAX package's engine."""
    th = Transcript(b"curdleproofs")
    s = sd.from_host(th.inner.strobe, device=CPU)
    j = jsd.from_host(th.inner.strobe)
    f = jax.jit(lambda s: jsd.get_and_append_challenge(s, b"c"))
    for _ in range(6):
        want = th.get_and_append_challenge(b"c")
        s, got = _pure(sd.get_and_append_challenge, s, b"c")
        j, jgot = f(j)
        assert int.from_bytes(_bytes(got), "big") == want
        assert _bytes(got) == _bytes(jgot)
        assert _same(s, th.inner.strobe)
        assert _bytes(s.st) == _bytes(j.st)
        assert (s.pos, s.pos_begin) == (int(j.pos), int(j.pos_begin))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_functional_strobe_matches_host(cuda_device, monkeypatch):
    """On the card (strobe_absorb_stream, strobe_challenge32): 40 operations
    across the rate, 6 chained challenges and 3 under labels of 33, 127 and
    300 bytes, as the host, state unchanged by every call; each challenge
    one launch of the kernel, none through its plain version."""
    from go_curdleproofs_tpu_torch.ops import kernels

    def no_plain(*args):
        raise AssertionError("a CUDA state reached the plain version")

    monkeypatch.setattr(kernels, "strobe_challenge32_plain", no_plain)

    rng = random.Random(41)
    th = Transcript(b"card")
    h = th.inner.strobe
    s = sd.from_host(h, device=cuda_device)
    kernels.reset_launches()
    for _ in range(40):
        n = rng.choice([1, 48, 52, 120, 200])
        data = bytes(rng.randrange(256) for _ in range(n))
        kind = rng.choice(["meta", "ad", "prf"])
        if kind == "meta":
            h.meta_ad(data, False)
            s = _pure(sd.meta_ad, s, data, False)
        elif kind == "ad":
            h.ad(data, False)
            s = _pure(sd.ad, s, _dev(data).to(cuda_device), False)
        else:
            want = h.prf(n, False)
            s, out = _pure(sd.prf, s, n)
            assert _bytes(out.cpu()) == want
        assert _same(s, h)
    for label in [b"c"] * 6 + [bytes(range(33)), b"l" * 127, b"m" * 300]:
        before = dict(kernels.launches)
        want = th.get_and_append_challenge(label)
        s, got = _pure(sd.get_and_append_challenge, s, label)
        assert int.from_bytes(_bytes(got.cpu()), "big") == want
        assert _same(s, h)
        assert {k: n - before[k] for k, n in kernels.launches.items()
                if n != before[k]} == {"strobe_challenge32": 1}, label
    assert kernels.launches["strobe_absorb_stream"] > 40
    assert kernels.launches["strobe_challenge32"] == 9
