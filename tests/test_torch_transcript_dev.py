"""The port's device transcript (go_curdleproofs_tpu_torch/ops/keccak_dev.py,
ops/strobe_dev.py and the plain versions of the two transcript kernels in
ops/kernels.py) against the JAX package's ops/keccak_dev.py and
ops/strobe_dev.py and against the port's host Transcript, byte for byte."""

import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_curdleproofs_tpu.ops import keccak_dev as jkeccak_dev
from go_curdleproofs_tpu.ops import strobe_dev as jsd
from go_curdleproofs_tpu.utils.transcript import Transcript as JTranscript
from go_curdleproofs_tpu_torch import convert
from go_curdleproofs_tpu_torch.models import device_common
from go_curdleproofs_tpu_torch.ops import kernels, keccak_dev, strobe_dev
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils import keccak
from go_curdleproofs_tpu_torch.utils.transcript import Transcript

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _state_bytes(ts):
    return bytes(ts.st.tolist())


def _host_state(t):
    s = t.inner.strobe
    return bytes(s.state), s.pos, s.pos_begin


def test_f1600_matches_jax_and_host_keccak():
    rng = random.Random(1)
    for state in (bytes(200), rng.randbytes(200)):
        want = bytearray(state)
        keccak.f1600(want)
        got = kernels.f1600_plain(torch.tensor(list(state),
                                               dtype=torch.uint8))
        assert bytes(got.tolist()) == bytes(want)
        jst = jnp.asarray(np.frombuffer(state, np.uint8).astype(np.int32))
        jout = jkeccak_dev.f1600(jst.reshape(25, 8)).reshape(200)
        assert bytes(np.asarray(jout).astype(np.uint8)) == bytes(want)
    assert kernels.f1600_plain is keccak_dev.f1600


def test_transcript_cu_tables_are_keccak():
    """transcript.cu's round constants, rotations and lane cycle (the card
    compiles them; here they are read back and run as Python ints against
    the host permutation), and its copy of r."""
    src = (Path(kernels.__file__).parent / "csrc"
           / "transcript.cu").read_text()

    def table(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
        return [int(w.strip().rstrip("ul"), 0) for w in body.split(",")]

    rc, rotc, piln = table("kRC"), table("kRotc"), table("kPiln")
    assert bytes(table("kRBytesBE")) == fh.R.to_bytes(32, "big")
    m64 = (1 << 64) - 1
    rotl = lambda x, n: ((x << n) | (x >> (64 - n))) & m64
    state = random.Random(2).randbytes(200)
    a = [int.from_bytes(state[8 * i:8 * i + 8], "little") for i in range(25)]
    for rnd in range(24):                    # the kernel's loop, line by line
        bc = [a[i] ^ a[i + 5] ^ a[i + 10] ^ a[i + 15] ^ a[i + 20]
              for i in range(5)]
        for i in range(5):
            t = bc[(i + 4) % 5] ^ rotl(bc[(i + 1) % 5], 1)
            for j in range(0, 25, 5):
                a[j + i] ^= t
        t = a[1]
        for i in range(24):
            j = piln[i]
            a[j], t = rotl(t, rotc[i]), a[j]
        for j in range(0, 25, 5):
            bc = a[j:j + 5]
            for i in range(5):
                a[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5] & m64
        a[0] ^= rc[rnd]
    want = bytearray(state)
    keccak.f1600(want)
    assert b"".join(v.to_bytes(8, "little") for v in a) == bytes(want)


def _pair(label=b"curdleproofs", prefix=b""):
    """A host transcript and the port's TState at the same point."""
    host = Transcript(label)
    if prefix:
        host.append_message(b"prefix", prefix)
    return host, device_common.transcript_to_device(host, CPU)


def test_tstate_appends_match_host_and_jax():
    rng = random.Random(3)
    host, ts = _pair(prefix=b"hello")
    jhost = JTranscript(b"curdleproofs")
    jhost.append_message(b"prefix", b"hello")
    js = jhost.inner.strobe
    jts = jsd.TState(jnp.asarray(np.frombuffer(bytes(js.state), np.uint8)
                                 .astype(np.int32)), js.pos, js.pos_begin)
    # state carried across: the JAX device state and the port's are one
    carried = convert.tstate_from_jax(np.asarray(jts.st), jts.pos,
                                      jts.pos_begin, device=CPU)
    assert (_state_bytes(carried), carried.pos, carried.pos_begin) \
        == (_state_bytes(ts), ts.pos, ts.pos_begin)

    msg = rng.randbytes(52)
    rows = np.frombuffer(rng.randbytes(9 * 48), np.uint8).reshape(9, 48)
    const_rows = np.frombuffer(rng.randbytes(5 * 32), np.uint8).reshape(5, 32)
    # a single message, traced rows (a device tensor), constant rows (host)
    host.append_message(b"ipa_step1", msg)
    ts.append_message(b"ipa_step1", msg)
    jts.append_message(b"ipa_step1", jnp.asarray(
        np.frombuffer(msg, np.uint8).astype(np.int32)))
    for r in rows:
        host.append_message(b"same_msm_step1", bytes(r))
    ts.append_rows(b"same_msm_step1", torch.from_numpy(rows.copy()))
    jts.append_rows(b"same_msm_step1", jnp.asarray(rows.astype(np.int32)))
    for r in const_rows:
        host.append_message(b"same_perm_step1", bytes(r))
    ts.append_rows(b"same_perm_step1", const_rows)
    jts.append_rows(b"same_perm_step1", const_rows.astype(np.int32))

    assert (_state_bytes(ts), ts.pos, ts.pos_begin) == _host_state(host)
    jst, jpos, jpb = convert.tstate_to_jax(ts)
    assert (jst == np.asarray(jts.st)).all()
    assert (jpos, jpb) == (jts.pos, jts.pos_begin)

    # one raw 32-byte challenge (no rejection test), then the full
    # get_and_append_challenge, on all three
    raw = host.inner.challenge_bytes(b"ipa_alpha", 32)
    assert bytes(ts.challenge_bytes32(b"ipa_alpha").tolist()) == raw
    jraw = jts.challenge_bytes32(b"ipa_alpha")
    assert bytes(np.asarray(jraw).astype(np.uint8)) == raw
    c = host.get_and_append_challenge(b"ipa_beta")
    got = ts.get_and_append_challenge(b"ipa_beta")
    jgot = jts.get_and_append_challenge(b"ipa_beta")
    assert int.from_bytes(bytes(got.tolist()), "big") == c
    assert bytes(np.asarray(jgot).astype(np.uint8)) == bytes(got.tolist())
    assert (_state_bytes(ts), ts.pos, ts.pos_begin) == _host_state(host)
    assert (np.asarray(jts.st) == ts.st.numpy()).all()
    assert (ts.pos, ts.pos_begin) == (jts.pos, jts.pos_begin) \
        == strobe_dev.post_challenge_pos(b"ipa_beta")
    assert fh.R > device_common.scalar_of(got.numpy()) == c
    assert device_common.fr.to_ints(device_common.challenge_to_fr(got)) == [c]


def test_challenge_rejection_matches_host():
    """Six challenges in a row under one label from the fresh transcript
    (the JAX package's rejection test): at least one first squeeze is
    rejected on the way, and the device loop resamples as the host does."""
    host, ts = _pair()
    rejected = 0
    for _ in range(6):
        probe = Transcript(b"curdleproofs")
        probe.inner.strobe.state[:] = host.inner.strobe.state
        probe.inner.strobe.pos = host.inner.strobe.pos
        probe.inner.strobe.pos_begin = host.inner.strobe.pos_begin
        rejected += int.from_bytes(
            probe.inner.challenge_bytes(b"c", 32), "big") >= fh.R
        exp = host.get_and_append_challenge(b"c")
        got = ts.get_and_append_challenge(b"c")
        assert int.from_bytes(bytes(got.tolist()), "big") == exp
    assert rejected >= 1
    assert (_state_bytes(ts), ts.pos, ts.pos_begin) == _host_state(host)


@pytest.mark.parametrize("prefix_len", [0, 7, 60, 110, 139, 140, 141, 163])
def test_challenge_from_every_kind_of_position(prefix_len):
    """Challenges whose headers cross the rate, end on it, or stay inside
    it, with at least one rejected first attempt among the prefixes."""
    label = b"same_msm_gamma"
    host, ts = _pair(prefix=bytes(prefix_len))
    want = host.get_and_append_challenge(label)
    st, chal = kernels.strobe_challenge32(ts.st, label, ts.pos, ts.pos_begin)
    assert int.from_bytes(bytes(chal.tolist()), "big") == want
    assert (bytes(st.tolist()),) + strobe_dev.post_challenge_pos(label) \
        == _host_state(host)


def test_absorb_stream_plain_crossings_and_final_permutation():
    rng = random.Random(4)
    host, ts = _pair(prefix=bytes(100))
    data = rng.randbytes(400)
    s = host.inner.strobe
    pos, pb = s.pos, s.pos_begin
    n_cross = (pos + len(data)) // 166
    pbs = torch.tensor([pb] + [0] * (n_cross - 1), dtype=torch.uint8)
    stream = torch.tensor(list(data), dtype=torch.uint8)
    got = kernels.strobe_absorb_stream(ts.st, stream, pos, pbs)
    s._absorb(data)
    assert bytes(got.tolist()) == bytes(s.state)
    forced = kernels.strobe_absorb_stream(ts.st, stream, pos, pbs, final_pb=0)
    s._run_f()
    assert bytes(forced.tolist()) == bytes(s.state)


LAYOUTS = [(0, 0, b"ipa_loop", 4, 48), (17, 3, b"same_msm_step1", 16, 48),
           (160, 155, b"same_perm_step1", 12, 32), (165, 0, b"x", 3, 1),
           (32, 0, b"gprod_step1", 1, 32)]


@pytest.mark.parametrize("case", LAYOUTS, ids=[str(c[:2]) for c in LAYOUTS])
def test_bulk_layout_equals_jax(case):
    pos, pb, label, k, L = case
    want = jsd._bulk_layout(pos, pb, label, k, L)
    got = strobe_dev._bulk_layout(pos, pb, label, k, L)
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    assert tuple(got[2:]) == tuple(want[2:])
    rows = np.arange(k * L, dtype=np.int32).reshape(k, L) % 251
    wc = jsd._bulk_layout(pos, pb, label, k, L, const_rows=rows)
    gc = strobe_dev._bulk_layout(pos, pb, label, k, L, const_rows=rows)
    assert (gc[0] == wc[0]).all() and len(gc[1]) == 0
    assert tuple(gc[2:]) == tuple(wc[2:])


def test_post_challenge_pos_equals_jax():
    for label in (b"ipa_gamma", b"same_msm_gamma", b"same_perm_alpha", b"c",
                  b"gprod_beta", b"sameexp_alpha", b"l" * 120):
        assert strobe_dev.post_challenge_pos(label) \
            == jsd.post_challenge_pos(label)
    assert strobe_dev._sim_msgs_pos(100, 5, [(9, 48)] * 7) \
        == jsd._sim_msgs_pos(100, 5, [(9, 48)] * 7)
