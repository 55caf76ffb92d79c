"""The challenge kernel of the device transcript (ops/csrc/transcript.cu:
strobe_challenge32_kernel), checked on the CPU.

A CUDA kernel runs only on a card. This file holds a 32-lane model of each
instantiation of the kernel's template: the state in lanes (lane i < 25
holds state lane i as two 32-bit words), a header as a byte string spread
over the warp as words and gathered onto the state lanes by shuffles and
funnel shifts, the permutation on the warp model of
tests/test_torch_transcript_dev.py, the squeeze and the big-endian compare
with r by two ballots, and the absorb of the accepted challenge. r's words
and the flags are read from the kernel's source.

The short instantiation (challenge_short, labels of at most 32 bytes: the
one crossing of the rate that a first attempt can make) is held byte for
byte against the plain version strobe_challenge32_plain, the port's host
Transcript and, at every kind of position, the JAX package's
TState.get_and_append_challenge: from every start position 0-165, with
pos_begin at each kind of position, labels of 0, 1, 9 and 32 bytes, and
states whose challenge takes 1, 2 and 3 attempts. The long one
(challenge_long, labels of any length: headers walked in chunks of 128
bytes, several crossings in a first attempt, retries and a re-absorb that
cross) is held against the plain version and the host Transcript at
labels of 33-300 bytes on both sides of every bound of the short design,
from starts where the first header stays inside the rate, crosses it once
or twice, and where the rate's last byte takes each kind of header byte,
with its permutations counted. Tolerance 0.
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


def xor_segment(lo, hi, words, s0, s1, h0):
    """xor_segment: each lane gathers the string's bytes [o, o + 8) by
    three shuffles and two funnel shifts, masked to its share of [s0,
    s1); words past the warp's 32 lanes read as 0."""
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
    """State byte k ^= v, on the lane that holds it (in place)."""
    lane, b = k >> 3, (k & 7) * 8
    if b < 32:
        lo[lane] ^= v << b
    else:
        hi[lane] ^= v << (b - 32)


def squeeze_below_r(lo, hi, clo, chi):
    """Lanes 0-3 take the challenge's words and zero theirs; the two
    ballots against r's words, and the lowest lane that differs decides."""
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
    return bool(lt & diff & -diff)


def challenge_words(clo, chi):
    """The accepted challenge as lane words: lanes 0-7, by shuffles."""
    cx = _shfl(clo, [(lane >> 1) & 3 for lane in range(32)])
    cy = _shfl(chi, [(lane >> 1) & 3 for lane in range(32)])
    return [(cy[w] if w & 1 else cx[w]) if w < 8 else 0 for w in range(32)]


def challenge_bytes_of(clo, chi):
    return b"".join(clo[i].to_bytes(4, "little") + chi[i].to_bytes(4, "little")
                    for i in range(4))


def challenge_lane_model(state, label, pos, pos_begin):
    """strobe_challenge32_kernel<false> (challenge_short: labels of at most
    32 bytes), statement by statement, on 32 lanes. Returns (state bytes,
    challenge bytes, attempts, permutations)."""
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
        if squeeze_below_r(lo, hi, clo, chi):
            break
        p0, pb_old, h = 32, 0, 0
    lo, hi = xor_segment(lo, hi, [header_word(w, 0, 33, FLAGS["A"])
                                  for w in range(32)], 32, 32 + nh, 0)
    lo, hi = xor_segment(lo, hi, challenge_words(clo, chi), 32 + nh,
                         64 + nh, 0)
    chal = challenge_bytes_of(clo, chi)
    return _from_lanes(lo, hi), chal, attempts, perms


def long_header_byte(label, i, pb0, pbq, flag):
    """long_header_byte: byte i of [pb0, M|A, label, 32, 0, 0, 0, pbq,
    flag], 0 past its end."""
    n = len(label)
    if i == 0:
        return pb0
    if i == 1:
        return FLAGS["M"] | FLAGS["A"]
    if i < 2 + n:
        return label[i - 2]
    return {2 + n: 32, 6 + n: pbq, 7 + n: flag}.get(i, 0)


def challenge_long_lane_model(state, label, pos, pos_begin):
    """strobe_challenge32_kernel<true> (challenge_long: labels of any
    length), statement by statement, on 32 lanes: every byte string
    absorbed segment by segment between rate crossings, its header in
    chunks of 128 bytes (32 lane words), a permutation at every crossing
    and after every attempt. Returns (state bytes, challenge bytes,
    attempts, permutations)."""
    lo, hi = _to_lanes(state)
    n = len(label)
    nh, q = n + 8, 6 + n
    p0, pb0, h, accepted = pos, pos_begin, 0, False
    clo, chi, cw = [0] * 32, [0] * 32, [0] * 32
    attempts = perms = 0
    while True:
        m = nh + 32 if accepted else nh
        first = RATE - p0
        q_first = q < first
        pbq = p0 + 1 if q_first else 0
        pb_op = (p0 + q if q_first else (q - first) % RATE) + 1
        flag = (FLAGS["A"] if accepted
                else FLAGS["I"] | FLAGS["A"] | FLAGS["C"])
        s0 = p0 if h == 0 else 0
        take = min(RATE - s0, m - h)
        s1 = s0 + take
        hend = min(h + take, nh)
        c = h >> 7
        while 128 * c < hend:
            words = [sum(long_header_byte(label, 128 * c + 4 * w + j, pb0,
                                          pbq, flag) << (8 * j)
                         for j in range(4)) for w in range(32)]
            lo, hi = xor_segment(lo, hi, words, s0, s1, h - 128 * c)
            c += 1
        if h + take > nh:
            lo, hi = xor_segment(lo, hi, cw, s0, s1, h - nh)
        if h + take - 1 < q:
            fpb = p0 + 1 if h == 0 else 0
        else:
            fpb = pb_op if h <= q else 0
        h += take
        if s1 == RATE or not accepted:
            xor_byte(lo, hi, s1, fpb)
            xor_byte(lo, hi, s1 + 1, 0x04)
            xor_byte(lo, hi, RATE + 1, 0x80)
            lo, hi = warp_f1600(lo, hi)
            perms += 1
        if h < m:
            continue
        if accepted:
            break
        attempts += 1
        if squeeze_below_r(lo, hi, clo, chi):
            accepted = True
            cw = challenge_words(clo, chi)
        p0, pb0, h = 32, 0, 0
    return _from_lanes(lo, hi), challenge_bytes_of(clo, chi), attempts, perms


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


# labels over 32 bytes on both sides of every bound of the short design:
# the re-absorbed message crosses the rate from 94 bytes, a retry's header
# from 126, the first header cannot stay inside the rate from 158 and can
# cross it twice from 159
LONG_LENS = (33, 93, 94, 95, 125, 126, 127, 166, 167, 300)


def long_label(n):
    return bytes((7 * i + 65) % 256 for i in range(n))


def first_header_starts(n, rng):
    """Three start positions for a label of n bytes: the first attempt's
    header (n + 8 bytes) inside the rate, crossing it once and crossing it
    twice, each where n allows it; then the rate's last byte or 0."""
    starts = []
    for crossings in (0, 1, 2):
        ps = [p for p in range(RATE) if (p + n + 8) // RATE == crossings]
        if ps:
            starts.append(rng.choice(ps))
    for p in (RATE - 1, 0):
        if len(starts) < 3 and p not in starts:
            starts.append(p)
    return starts


def edge_starts(n):
    """Start positions at which the rate's last byte takes each kind of
    byte of the first header [pb_old, M|A, label (n bytes), 32, 0, 0, 0,
    pb, flag], at its first or its second crossing."""
    offsets = (0, 1, 2, n + 1, n + 2, n + 5, n + 6, n + 7)
    return sorted({(RATE - 1 - e) % RATE for e in offsets})


def long_permutations(pos, n, attempts):
    """Permutations of a challenge under a label of n bytes: one at every
    rate crossing of an attempt's header and one after it unless it ends
    on the rate (the first from pos, every retry from 32), then one at
    every crossing of the re-absorbed message (n + 40 bytes from 32)."""
    def header(p):
        return (p + n + 8) // RATE + ((p + n + 8) % RATE != 0)

    return header(pos) + (attempts - 1) * header(32) + (n + 72) // RATE


def expected_permutations(pos, label, attempts):
    """One an attempt, and one more where the first attempt's header
    crosses the rate before its last byte."""
    hc, nh = RATE - pos, len(label) + 8
    return attempts + (hc < nh)


def _cu_body(name):
    start = CU_SOURCE.index(name + "(")
    return CU_SOURCE[start:CU_SOURCE.index("\n}\n", start)]


def test_model_tables_are_the_kernel_s():
    assert b"".join(w.to_bytes(8, "big") for w in R_WORDS) \
        == fh.R.to_bytes(32, "big")
    assert FLAGS == {"I": 1, "A": 2, "C": 4, "M": 16}
    kernel = _cu_body("strobe_challenge32_kernel")
    assert "challenge_long(" in kernel and "challenge_short(" in kernel
    assert "keccak_f1600_warp(" not in kernel
    for path in ("challenge_short", "challenge_long"):
        body = _cu_body(path)
        assert body.count("keccak_f1600_warp(") == 1, \
            f"{path}: one permutation call site"
        assert "run_f" not in body and "__shared__" not in body
    assert "128 * c" in _cu_body("challenge_long"), "chunks of 128 bytes"


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


@pytest.mark.parametrize("n", LONG_LENS)
def test_challenge_long_lane_model(n):
    """The long instantiation's model under a label of n bytes, from a
    start where the first header stays inside the rate, one where it
    crosses once and one where it crosses twice (where n allows each),
    at 1, 2 and 3 attempts, then from every edge start at 1, 2 or 3:
    permutations counted, and byte for byte the plain version and the
    host Transcript."""
    rng = random.Random(3000 + n)
    label = long_label(n)
    cases = [(p, a) for p in first_header_starts(n, rng) for a in (1, 2, 3)]
    cases += [(p, 1 + i % 3) for i, p in enumerate(edge_starts(n))]
    for start, attempts in cases:
        pb = rng.randrange(RATE + 1)
        state = state_with_attempts(rng, start, pb, label, attempts)
        got_st, got_ch, n_att, perms = challenge_long_lane_model(
            state, label, start, pb)
        assert n_att == attempts
        assert perms == long_permutations(start, n, attempts)
        host = _host(state, start, pb)
        c = host.get_and_append_challenge(label)
        s = host.inner.strobe
        assert int.from_bytes(got_ch, "big") == c
        assert got_st == bytes(s.state), (start, attempts, pb)
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
