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


CU_SOURCE = (Path(kernels.__file__).parent / "csrc"
             / "transcript.cu").read_text()
M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


def _cu_table(name):
    body = re.search(name + r"\[\d+\] = \{([^}]*)\}", CU_SOURCE).group(1)
    return [int(w.strip().rstrip("ul"), 0) for w in body.split(",")]


RC, RHO, PI_SRC = _cu_table("kRC"), _cu_table("kRho"), _cu_table("kPiSrc")


def test_transcript_cu_tables_are_keccak():
    """transcript.cu's round constants, per-lane rotations and pi sources
    (the card compiles them; here they are read back and run on 25 state
    lanes as Python ints against the host permutation), and its copy of
    r."""
    assert b"".join(w.to_bytes(8, "big") for w in _cu_table("kRWordsBE")) \
        == fh.R.to_bytes(32, "big")
    assert sorted(PI_SRC) == list(range(25)) and len(RHO) == 25
    rotl = lambda x, n: ((x << n) | (x >> (64 - n))) & M64 if n else x
    state = random.Random(2).randbytes(200)
    a = [int.from_bytes(state[8 * i:8 * i + 8], "little") for i in range(25)]
    for rnd in range(24):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        a = [v ^ c[(i + 4) % 5] ^ rotl(c[(i + 1) % 5], 1)
             for i, v in enumerate(a)]
        b = [rotl(v, RHO[i]) for i, v in enumerate(a)]
        b = [b[PI_SRC[i]] for i in range(25)]
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + i - i % 5] & M64
                     & b[(i % 5 + 2) % 5 + i - i % 5]) for i in range(25)]
        a[0] ^= RC[rnd]
    want = bytearray(state)
    keccak.f1600(want)
    assert b"".join(v.to_bytes(8, "little") for v in a) == bytes(want)


# -- a model of the warp: 32 lanes, 32-bit halves, shuffles ----------------------

def _shfl(vals, src):
    """__shfl_sync over the warp: lane i reads vals[src[i] % 32]."""
    return [vals[s % 32] for s in src]


def _funnel_l(lo, hi, s):
    """__funnelshift_l(lo, hi, s): the high word of hi:lo << (s & 31)."""
    s &= 31
    return ((hi << s) | (lo >> (32 - s))) & M32 if s else hi


def _lanes():
    """lane_consts() of transcript.cu for every warp lane."""
    out = []
    for lane in range(32):
        i = lane if lane < 25 else 0
        x, y = i % 5, i // 5
        out.append(dict(lane=lane, xm1=(x + 4) % 5, xp1=(x + 1) % 5,
                        c1=(x + 1) % 5 + 5 * y, c2=(x + 2) % 5 + 5 * y,
                        pi=PI_SRC[i], swap=RHO[i] >= 32, rot=RHO[i] & 31))
    return out


LANES = _lanes()


def warp_f1600(lo, hi):
    """keccak_f1600_warp, statement by statement, on 32 lanes."""
    col = lambda k: [ln[k] for ln in LANES]
    me = col("lane")
    for rnd in range(24):
        pl = [u ^ v for u, v in zip(lo, _shfl(lo, [i + 5 for i in me]))]
        ph = [u ^ v for u, v in zip(hi, _shfl(hi, [i + 5 for i in me]))]
        pl = [u ^ v for u, v in zip(pl, _shfl(pl, [i + 10 for i in me]))]
        ph = [u ^ v for u, v in zip(ph, _shfl(ph, [i + 10 for i in me]))]
        pl = [u ^ v for u, v in zip(pl, _shfl(lo, [i + 20 for i in me]))]
        ph = [u ^ v for u, v in zip(ph, _shfl(hi, [i + 20 for i in me]))]
        ml, mh = _shfl(pl, col("xm1")), _shfl(ph, col("xm1"))
        nl, nh = _shfl(pl, col("xp1")), _shfl(ph, col("xp1"))
        lo = [v ^ a ^ _funnel_l(c, b, 1)
              for v, a, b, c in zip(lo, ml, nl, nh)]
        hi = [v ^ a ^ _funnel_l(b, c, 1)
              for v, a, b, c in zip(hi, mh, nl, nh)]
        sl = [h if ln["swap"] else v for v, h, ln in zip(lo, hi, LANES)]
        sh = [v if ln["swap"] else h for v, h, ln in zip(lo, hi, LANES)]
        lo = _shfl([_funnel_l(b, a, ln["rot"])
                    for a, b, ln in zip(sl, sh, LANES)], col("pi"))
        hi = _shfl([_funnel_l(a, b, ln["rot"])
                    for a, b, ln in zip(sl, sh, LANES)], col("pi"))
        al, ah = _shfl(lo, col("c1")), _shfl(hi, col("c1"))
        bl, bh = _shfl(lo, col("c2")), _shfl(hi, col("c2"))
        lo = [v ^ (~a & M32 & b) for v, a, b in zip(lo, al, bl)]
        hi = [v ^ (~a & M32 & b) for v, a, b in zip(hi, ah, bh)]
        lo[0] ^= RC[rnd] & M32
        hi[0] ^= RC[rnd] >> 32
    return lo, hi


def _to_lanes(state):
    lo = [int.from_bytes(state[8 * i:8 * i + 4], "little") if i < 25 else 0
          for i in range(32)]
    hi = [int.from_bytes(state[8 * i + 4:8 * i + 8], "little")
          if i < 25 else 0 for i in range(32)]
    return lo, hi


def _from_lanes(lo, hi):
    return b"".join(lo[i].to_bytes(4, "little") + hi[i].to_bytes(4, "little")
                    for i in range(25))


def test_warp_lane_model_is_keccak():
    """The warp's round, 32 lanes with shuffles by transcript.cu's tables
    (lanes 25-31 along), against the plain version, the JAX package's
    f1600 and the host Keccak."""
    rng = random.Random(8)
    for state in (bytes(200), rng.randbytes(200), bytes([255]) * 200):
        want = bytearray(state)
        keccak.f1600(want)
        assert _from_lanes(*warp_f1600(*_to_lanes(state))) == bytes(want)
        plain = kernels.f1600_plain(torch.tensor(list(state),
                                                 dtype=torch.uint8))
        assert bytes(plain.tolist()) == bytes(want)
        jst = jnp.asarray(np.frombuffer(state, np.uint8).astype(np.int32))
        jout = jkeccak_dev.f1600(jst.reshape(25, 8)).reshape(200)
        assert bytes(np.asarray(jout).astype(np.uint8)) == bytes(want)


def absorb_lane_model(state, stream, pos, pbs, final_pb=None):
    """strobe_absorb_stream_kernel, statement by statement: each lane XORs
    its 8 bytes of a block as two words, run_f's bytes go to the lanes
    that hold them, the permutation is the warp model."""
    lo, hi = _to_lanes(state)
    n = len(stream)

    def load_block(src_off, s0, s1):
        out = []
        for lane in range(32):
            bs = [stream[src_off + k - s0] if s0 <= k < s1 else 0
                  for k in range(8 * lane, 8 * lane + 8)]
            out.append((int.from_bytes(bytes(bs[:4]), "little"),
                        int.from_bytes(bytes(bs[4:]), "little")))
        return out

    def run_f(lo, hi, p, pb):
        for k, v in ((p, pb), (p + 1, 0x04), (167, 0x80)):
            lane, b = k >> 3, (k & 7) * 8
            if b < 32:
                lo[lane] ^= v << b
            else:
                hi[lane] ^= v << (b - 32)
        return warp_f1600(lo, hi)

    crossings = (pos + n) // 166
    off = crossing = 0
    take = min(166 - pos, n)
    nxt = load_block(0, pos, pos + take)
    pb_next = pbs[0] if crossings else 0
    while off < n:
        lo = [v ^ w[0] for v, w in zip(lo, nxt)]
        hi = [v ^ w[1] for v, w in zip(hi, nxt)]
        pos += take
        off += take
        if pos == 166:
            pb = pb_next
            crossing += 1
            pb_next = pbs[crossing] if crossing < crossings else 0
            take = min(166, n - off)
            nxt = load_block(off, 0, take)
            lo, hi = run_f(lo, hi, 166, pb)
            pos = 0
    if final_pb is not None and pos != 0:
        lo, hi = run_f(lo, hi, pos, final_pb)
    return _from_lanes(lo, hi)


ABSORB_STARTS = (0, 1, 7, 8, 159, 160, 165)
ABSORB_LENGTHS = (0, 1, 5, 6, 166, 167, 1000)


@pytest.mark.parametrize("start", ABSORB_STARTS)
def test_absorb_lane_model_matches_plain_and_host(start):
    """The kernel's block loop on lanes at every start position against
    the plain version (random pos_begin bytes) and the host STROBE (the
    pos_begin it would use), with and without the forced permutation."""
    rng = random.Random(start)
    state = rng.randbytes(200)
    for n in ABSORB_LENGTHS:
        data = rng.randbytes(n)
        n_cross = (start + n) // 166
        pbs = [rng.randrange(167) for _ in range(n_cross)]
        st_t = torch.tensor(list(state), dtype=torch.uint8)
        data_t = torch.tensor(list(data), dtype=torch.uint8)
        for final_pb in (None, 9):
            want = kernels.strobe_absorb_stream_plain(
                st_t, data_t, start, torch.tensor(pbs, dtype=torch.uint8),
                final_pb)
            assert absorb_lane_model(state, data, start, pbs, final_pb) \
                == bytes(want.tolist()), (n, final_pb)
        host = Transcript(b"x").inner.strobe
        host.state[:], host.pos, host.pos_begin = state, start, 3
        host_pbs = [3] + [0] * (n_cross - 1) if n_cross else []
        host._absorb(data)
        got = absorb_lane_model(state, data, start, host_pbs)
        assert got == bytes(host.state)
        if host.pos != 0:
            final_pb = host.pos_begin
            host._run_f()
            assert absorb_lane_model(state, data, start, host_pbs,
                                     final_pb) == bytes(host.state)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("start", ABSORB_STARTS)
def test_cuda_absorb_stream_at_every_start(cuda_device, start):
    """The warp kernel on the card at every start and length, with and
    without the forced permutation, against the plain version and the
    lane model."""
    rng = random.Random(start)
    state = rng.randbytes(200)
    st = torch.tensor(list(state), dtype=torch.uint8, device=cuda_device)
    for n in ABSORB_LENGTHS:
        data = rng.randbytes(n)
        pbs = [rng.randrange(167) for _ in range((start + n) // 166)]
        data_t = torch.tensor(list(data), dtype=torch.uint8,
                              device=cuda_device)
        pbs_t = torch.tensor(pbs, dtype=torch.uint8, device=cuda_device)
        for final_pb in (None, 9):
            got = kernels.strobe_absorb_stream(st, data_t, start, pbs_t,
                                               final_pb)
            want = kernels.strobe_absorb_stream_plain(st, data_t, start,
                                                      pbs_t, final_pb)
            assert torch.equal(got, want)
            assert bytes(got.tolist()) == absorb_lane_model(
                state, data, start, pbs, final_pb)


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
