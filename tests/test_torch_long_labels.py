"""Challenge labels of any length in the port's device transcript
(ops/strobe_dev.py: the functional `SState` and the prover's `TState`, both
on kernels.strobe_challenge32), on the CPU, where they run the kernel's
plain version.

At labels of 33-300 bytes, on both sides of every bound of the kernel's
short design (the first header inside the rate or crossing it once or
twice, a retry's header and the re-absorbed message crossing it), from
three start positions each and at states whose challenge takes 1, 2 and 3
attempts: both engines give the host Transcript's challenge, state bytes
and (pos, pos_begin), and leave their input state as it was. Three cases
against the JAX package: its functional SState at 166 bytes (its `absorb`
takes at most the rate, 166 bytes, at once) from a start where the header
crosses the rate, and its TState at 127 and 300 bytes. Tolerance 0.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_curdleproofs_tpu.ops import strobe_dev as jsd
from go_curdleproofs_tpu_torch.ops import strobe_dev as sd
from test_torch_challenge_lanes import (LONG_LENS, RATE, _host,
                                        first_header_starts, long_label,
                                        state_with_attempts)

torch.set_num_threads(1)


def _bytes(t) -> bytes:
    return bytes(np.asarray(t).astype(np.uint8).tolist())


def _host_after(state: bytes, start: int, pb: int, label: bytes):
    """(challenge, state bytes, pos, pos_begin) of the host Transcript."""
    host = _host(state, start, pb)
    chal = host.get_and_append_challenge(label)
    s = host.inner.strobe
    return chal, bytes(s.state), s.pos, s.pos_begin


@pytest.mark.parametrize("n", LONG_LENS)
def test_long_label_challenge_matches_host(n):
    rng = random.Random(5000 + n)
    label = long_label(n)
    for start in first_header_starts(n, rng):
        for attempts in (1, 2, 3):
            pb = rng.randrange(RATE + 1)
            state = state_with_attempts(rng, start, pb, label, attempts)
            chal, want_st, pos, pos_begin = _host_after(state, start, pb,
                                                        label)
            st = torch.tensor(list(state), dtype=torch.uint8)
            s, got = sd.get_and_append_challenge(sd.SState(st, start, pb),
                                                 label)
            assert int.from_bytes(_bytes(got), "big") == chal
            assert (_bytes(s.st), s.pos, s.pos_begin) \
                == (want_st, pos, pos_begin), (start, attempts, pb)
            ts = sd.TState(st, start, pb)
            got = ts.get_and_append_challenge(label)
            assert int.from_bytes(_bytes(got), "big") == chal
            assert (_bytes(ts.st), ts.pos, ts.pos_begin) \
                == (want_st, pos, pos_begin), (start, attempts, pb)
            assert _bytes(st) == state, "input state unchanged"


def test_long_label_matches_jax_sstate():
    """The JAX package's functional engine at a 166-byte label, from a
    start where the header crosses the rate inside the label, 2 attempts."""
    label, start = long_label(166), 100
    rng = random.Random(166)
    pb = rng.randrange(RATE + 1)
    state = state_with_attempts(rng, start, pb, label, 2)
    host = _host(state, start, pb)
    j = jsd.from_host(host.inner.strobe)
    j, jchal = jax.jit(lambda s: jsd.get_and_append_challenge(s, label))(j)
    s, chal = sd.get_and_append_challenge(
        sd.SState(torch.tensor(list(state), dtype=torch.uint8), start, pb),
        label)
    assert _bytes(chal) == _bytes(jchal)
    assert (_bytes(s.st), s.pos, s.pos_begin) \
        == (_bytes(j.st), int(j.pos), int(j.pos_begin))
    want, want_st, _, _ = _host_after(state, start, pb, label)
    assert int.from_bytes(_bytes(chal), "big") == want
    assert _bytes(s.st) == want_st


@pytest.mark.parametrize("n, start", [(127, 20), (300, 120)])
def test_long_label_matches_jax_tstate(n, start):
    """The JAX package's TState, 2 attempts: 127 bytes from a start where
    the first header stays inside the rate (a retry's header crosses it
    at its I|A|C pos_begin byte), 300 bytes from one where it crosses
    twice."""
    label = long_label(n)
    rng = random.Random(n)
    pb = rng.randrange(RATE + 1)
    state = state_with_attempts(rng, start, pb, label, 2)
    jts = jsd.TState(jnp.asarray(np.frombuffer(state, np.uint8)
                                 .astype(np.int32)), start, pb)
    jchal = jts.get_and_append_challenge(label)
    ts = sd.TState(torch.tensor(list(state), dtype=torch.uint8), start, pb)
    chal = ts.get_and_append_challenge(label)
    assert _bytes(chal) == _bytes(jchal)
    assert (_bytes(ts.st), ts.pos, ts.pos_begin) \
        == (_bytes(jts.st), jts.pos, jts.pos_begin)
