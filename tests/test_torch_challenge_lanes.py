"""The challenge kernel of the device transcript (ops/csrc/transcript.cu:
strobe_challenge32_kernel), checked on the CPU.

A CUDA kernel runs only on a card. This file holds a 32-lane model of the
kernel's schedule: the state in lanes (lane i < 25 holds state lane i as
two 32-bit words), an attempt's header as a byte string spread over the
warp as words and gathered onto the state lanes by shuffles and funnel
shifts, the one crossing of the rate that a first attempt can make, the
permutation on the warp model of tests/test_torch_transcript_dev.py, the
squeeze and the big-endian compare with r by two ballots, and the final
absorb of the accepted challenge. r's words and the flags are read from
the kernel's source.

The model is held byte for byte against the plain version
strobe_challenge32_plain, the port's host Transcript and, at every kind of
position, the JAX package's TState.get_and_append_challenge: from every
start position 0-165, with pos_begin at each kind of position, labels of
0, 1, 9 and 32 bytes, and states whose challenge takes 1, 2 and 3
attempts. Tolerance 0.
"""

import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_curdleproofs_tpu.ops import strobe_dev as jsd
from go_curdleproofs_tpu_torch.ops import kernels, strobe_dev
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils.transcript import Transcript
from test_torch_transcript_dev import (CU_SOURCE, M32, _cu_table,
                                       _from_lanes, _to_lanes, warp_f1600)

torch.set_num_threads(1)
RATE = 166
R_WORDS = _cu_table("kRWordsBE")
FLAGS = {k: int(v) for k, v in re.findall(r"kFlag(\w) = (\d+)", CU_SOURCE)}
LABELS = (b"", b"x", b"ipa_gamma", bytes(range(65, 97)))
STARTS = range(RATE)


def _funnel_r(lo, hi, s):
    """__funnelshift_r(lo, hi, s): the low word of hi:lo >> (s & 31)."""
    return ((hi << 32 | lo) >> (s & 31)) & M32


def _shfl(vals, src):
    return [vals[s % 32] for s in src]


def challenge_lane_model(state, label, pos, pos_begin):
    """strobe_challenge32_kernel, statement by statement, on 32 lanes.
    Returns (state bytes, challenge bytes, attempts, permutations)."""
    lo, hi = _to_lanes(state)
    n = len(label)
    nh = n + 8
    lw = [int.from_bytes(label[4 * j:4 * j + 4].ljust(4, b"\0"), "little")
          for j in range(8)]

    def label_word(w):
        return lw[w] if 0 <= w < 8 else 0

    lab = [(label_word(w) << 16 | (label_word(w - 1) >> 16 if w > 0 else 0))
           & M32 for w in range(32)]

    def header_word(w, pb_old, pb, flag):
        v = lab[w]
        if w == 0:
            v |= pb_old | (FLAGS["M"] | FLAGS["A"]) << 8
        tail = 32 | pb << 32 | flag << 40
        d = 4 * w - (2 + n)
        if -4 < d < 6:
            v |= ((tail >> (8 * d)) if d >= 0 else (tail << (-8 * d))) & M32
        return v

    def xor_segment(lo, hi, words, s0, s1, h0):
        """Each lane gathers the string's bytes [o, o + 8) by three
        shuffles and two funnel shifts, masked to its share of [s0, s1)."""
        lo, hi = list(lo), list(hi)
        o = [8 * lane - s0 + h0 for lane in range(32)]
        v = []
        for k in range(3):
            src = [(x >> 2) + k for x in o]
            got = _shfl(words, [s & 31 for s in src])
            v.append([g if 0 <= s < 32 else 0 for g, s in zip(got, src)])
        for lane in range(32):
            s = (o[lane] & 3) * 8
            vlo = _funnel_r(v[0][lane], v[1][lane], s)
            vhi = _funnel_r(v[1][lane], v[2][lane], s)
            frm, to = max(s0 - 8 * lane, 0), min(s1 - 8 * lane, 8)
            m = ((1 << (8 * (to - frm))) - 1) << (8 * frm) if frm < to else 0
            lo[lane] ^= vlo & m & M32
            hi[lane] ^= vhi & (m >> 32)
        return lo, hi

    def xor_byte(lo, hi, k, v):
        lane, b = k >> 3, (k & 7) * 8
        if b < 32:
            lo[lane] ^= v << b
        else:
            hi[lane] ^= v << (b - 32)

    p0, pb_old, h = pos, pos_begin, 0
    clo, chi = [0] * 32, [0] * 32
    attempts = perms = 0
    flag_iac = FLAGS["I"] | FLAGS["A"] | FLAGS["C"]
    while True:
        hc = RATE - p0
        cross = hc <= nh
        early = cross and hc <= 6 + n
        words = [header_word(w, pb_old, 0 if early else p0 + 1, flag_iac)
                 for w in range(32)]
        if h == 0:
            s0, s1 = p0, RATE if cross else p0 + nh
            fpos, fpb = s1, p0 + 1 if early else p0 + 7 + n
        else:
            s0, s1 = 0, nh - h
            fpos, fpb = s1, 7 + n - h if early else 0
        lo, hi = xor_segment(lo, hi, words, s0, s1, h)
        xor_byte(lo, hi, fpos, fpb)
        xor_byte(lo, hi, fpos + 1, 0x04)
        xor_byte(lo, hi, RATE + 1, 0x80)
        lo, hi = warp_f1600(lo, hi)
        perms += 1
        h += s1 - s0
        if h < nh:
            continue
        attempts += 1
        for lane in range(4):
            clo[lane], chi[lane] = lo[lane], hi[lane]
            lo[lane] = hi[lane] = 0
        lt = gt = 0
        for lane in range(4):
            v = int.from_bytes((clo[lane] | chi[lane] << 32).to_bytes(
                8, "little"), "big")
            lt |= (v < R_WORDS[lane]) << lane
            gt |= (v > R_WORDS[lane]) << lane
        diff = lt | gt
        if lt & diff & -diff:
            break
        p0, pb_old, h = 32, 0, 0
    lo, hi = xor_segment(lo, hi, [header_word(w, 0, 33, FLAGS["A"])
                                  for w in range(32)], 32, 32 + nh, 0)
    cx = _shfl(clo, [(lane >> 1) & 3 for lane in range(32)])
    cy = _shfl(chi, [(lane >> 1) & 3 for lane in range(32)])
    cw = [(cy[w] if w & 1 else cx[w]) if w < 8 else 0 for w in range(32)]
    lo, hi = xor_segment(lo, hi, cw, 32 + nh, 64 + nh, 0)
    chal = b"".join(clo[i].to_bytes(4, "little") + chi[i].to_bytes(4, "little")
                    for i in range(4))
    return _from_lanes(lo, hi), chal, attempts, perms


def _host(state, pos, pb):
    t = Transcript(b"challenge_lanes")
    s = t.inner.strobe
    s.state[:], s.pos, s.pos_begin = state, pos, pb
    return t


def attempts_of(state, pos, pb, label):
    t, n = _host(state, pos, pb), 1
    while int.from_bytes(t.inner.challenge_bytes(label, 32), "big") >= fh.R:
        n += 1
    return n


def state_with_attempts(rng, pos, pb, label, want):
    """A random state whose challenge at (pos, pb) under `label` takes
    `want` attempts."""
    for _ in range(500):
        state = rng.randbytes(200)
        if attempts_of(state, pos, pb, label) == want:
            return state
    raise AssertionError(f"no state with {want} attempts")


def pos_begin_kinds(start, rng):
    """pos_begin at each kind of position: 0 (after a permutation), the
    start itself, just past it, the rate's end, and anywhere."""
    return (0, start, min(start + 1, RATE), RATE, rng.randrange(RATE + 1))


def expected_permutations(pos, label, attempts):
    """One an attempt, and one more where the first attempt's header
    crosses the rate before its last byte."""
    hc, nh = RATE - pos, len(label) + 8
    return attempts + (hc < nh)


def test_model_tables_are_the_kernel_s():
    assert b"".join(w.to_bytes(8, "big") for w in R_WORDS) \
        == fh.R.to_bytes(32, "big")
    assert FLAGS == {"I": 1, "A": 2, "C": 4, "M": 16}
    start = CU_SOURCE.index("strobe_challenge32_kernel(")
    body = CU_SOURCE[start:CU_SOURCE.index("\n}\n", start)]
    assert body.count("keccak_f1600_warp(") == 1, "one permutation call site"
    assert "run_f" not in body and "__shared__" not in body


@pytest.mark.parametrize("start", STARTS)
def test_challenge_lane_model_from_every_start(start):
    """At this start: every label, 1, 2 and 3 attempts, pos_begin of each
    kind, against the plain version and the host Transcript."""
    rng = random.Random(1000 + start)
    kinds = pos_begin_kinds(start, rng)
    for li, label in enumerate(LABELS):
        for attempts in (1, 2, 3):
            pb = kinds[(li + attempts + start) % len(kinds)]
            state = state_with_attempts(rng, start, pb, label, attempts)
            got_st, got_ch, n_att, perms = challenge_lane_model(
                state, label, start, pb)
            assert n_att == attempts
            assert perms == expected_permutations(start, label, attempts)
            host = _host(state, start, pb)
            c = host.get_and_append_challenge(label)
            s = host.inner.strobe
            assert int.from_bytes(got_ch, "big") == c
            assert got_st == bytes(s.state), (label, attempts, pb)
            assert (s.pos, s.pos_begin) == strobe_dev.post_challenge_pos(
                label)
            w_st, w_ch = kernels.strobe_challenge32_plain(
                torch.tensor(list(state), dtype=torch.uint8), label, start,
                pb)
            assert bytes(w_st.tolist()) == got_st
            assert bytes(w_ch.tolist()) == got_ch


# the kinds of start for a label of n bytes (header n + 8): inside the rate,
# crossing in the M|A operation, at the I|A|C operation's pos_begin byte, at
# its flag byte (the header's last: no forced permutation), and from 165
JAX_CASES = [(10, b"ipa_gamma"), (149, b"ipa_gamma"), (150, b"ipa_gamma"),
             (151, b"ipa_gamma"), (165, b"ipa_gamma"), (157, b""),
             (158, b""), (126, bytes(range(65, 97))),
             (127, bytes(range(65, 97)))]


@pytest.mark.parametrize("case", JAX_CASES,
                         ids=[f"{p}-{len(lb)}" for p, lb in JAX_CASES])
def test_challenge_lane_model_matches_jax(case):
    """The JAX package's TState.get_and_append_challenge at each kind of
    start, with a state that takes 2 attempts."""
    start, label = case
    rng = random.Random(start)
    pb = rng.randrange(RATE + 1)
    state = state_with_attempts(rng, start, pb, label, 2)
    got_st, got_ch, _, _ = challenge_lane_model(state, label, start, pb)
    ts = jsd.TState(jnp.asarray(np.frombuffer(state, np.uint8)
                                .astype(np.int32)), start, pb)
    chal = np.asarray(ts.get_and_append_challenge(label)).astype(np.uint8)
    assert bytes(chal) == got_ch
    assert bytes(np.asarray(ts.st).astype(np.uint8)) == got_st
