"""The plain reference on its own: the Go reference's fixture proofs, a
flipped byte, a wrong pairing, and its primitives against hashlib and the
definitions."""

import hashlib
import json
import random
import struct
from pathlib import Path

import pytest

from benchmark.reference import bls, curdleproofs as cp
from benchmark.reference.rand import Rand
from benchmark.reference.transcript import keccak_f1600

FIXTURE = Path(__file__).resolve().parents[1] / "data" / \
    "fixture_whisk_ell124.json"


def _trackers(pairs):
    return [(bytes.fromhex(a), bytes.fromhex(b)) for a, b in pairs]


@pytest.fixture(scope="module")
def fixture():
    fx = json.loads(FIXTURE.read_text())
    crs = cp.make_crs(fx["ell"], fx["crs_seed"])
    insts = [(_trackers(i["pre"]), _trackers(i["post"]),
              bytes.fromhex(i["proof"])) for i in fx["instances"]]
    return crs, insts, bls.Decoder()


def test_accepts_the_fixture_proofs(fixture):
    crs, insts, dec = fixture
    for pre, post, proof in insts:
        assert cp.verify_shuffle(crs, pre, post, proof, dec, random.Random(1))


@pytest.mark.parametrize("where", [60, 1000, 4520])
def test_rejects_a_flipped_byte(fixture, where):
    """A byte of a point (60), of an IPA list (1000) and of the last
    scalar (4520; the encoded proof ends at byte 4,536)."""
    crs, insts, dec = fixture
    pre, post, proof = insts[0]
    bad = proof[:where] + bytes([proof[where] ^ 1]) + proof[where + 1:]
    assert not cp.verify_shuffle(crs, pre, post, bad, dec, random.Random(2))


def test_rejects_the_wrong_post_trackers(fixture):
    crs, insts, dec = fixture
    assert not cp.verify_shuffle(crs, insts[0][0], insts[1][1], insts[0][2],
                                 dec, random.Random(3))


def test_skipping_the_final_sum_accepts_the_wrong_pairing(fixture):
    """The control's broken guarantee: without the final sum nothing
    rejects a well-formed proof paired with other trackers."""
    crs, insts, dec = fixture
    assert cp.verify_shuffle(crs, insts[0][0], insts[1][1], insts[0][2],
                             dec, random.Random(3), final_check=False)


def _curve_point(x):
    while True:
        rhs = (x ** 3 + bls.B) % bls.P
        y = pow(rhs, (bls.P + 1) // 4, bls.P)
        if y * y % bls.P == rhs:
            return (x, y)
        x += 1


def test_subgroup_check_agrees_with_the_order():
    rng = random.Random(5)
    inside = [bls.mul(bls.G, rng.randrange(1, bls.R)) for _ in range(3)]
    outside = [_curve_point(rng.randrange(bls.P)) for _ in range(3)]
    for p in inside:
        assert bls.in_subgroup(p) and bls.in_subgroup_by_order(p)
    for p in outside:
        assert not bls.in_subgroup(p)
        assert not bls.in_subgroup_by_order(p)
        with pytest.raises(ValueError):
            bls.decode(bls.encode(p))


def test_decode_inverts_encode_and_refuses_bad_encodings():
    rng = random.Random(6)
    for _ in range(3):
        p = bls.mul(bls.G, rng.randrange(1, bls.R))
        assert bls.decode(bls.encode(p)) == p
    assert bls.decode(bls.encode(None)) is None
    good = bls.encode(bls.G)
    for bad in (bytes([good[0] & 0x1F]) + good[1:],        # no flags
                bytes([0xE0]) + good[1:],                   # all three
                bytes([0x9F]) + b"\xff" * 47,               # x >= p
                bytes([0xC0]) + b"\x00" * 46 + b"\x01"):    # infinity + junk
        with pytest.raises(ValueError):
            bls.decode(bad)


def test_msm_is_the_sum_of_multiples():
    rng = random.Random(7)
    pts = [bls.mul(bls.G, rng.randrange(1, bls.R)) for _ in range(9)] + [None]
    sc = [rng.randrange(bls.R) for _ in pts[:-2]] + [0, 5]
    want = bls.add_points(*(bls.mul(p, s) for p, s in zip(pts, sc)))
    assert bls.to_affine(bls.msm(pts, sc)) == want
    assert bls.msm(pts[:3], [1, 1, bls.R - 2])[2] != 0


def test_keccak_is_sha3_256():
    """keccak_f1600 in a SHA3-256 sponge against hashlib."""
    for msg in (b"", b"abc", bytes(range(256)) * 3):
        st = bytearray(200)
        data = msg + b"\x06" + bytes(-(len(msg) + 1) % 136)
        data = data[:-1] + bytes([data[-1] | 0x80])
        for i in range(0, len(data), 136):
            for j, b in enumerate(data[i:i + 136]):
                st[j] ^= b
            keccak_f1600(st)
        assert bytes(st[:32]) == hashlib.sha3_256(msg).digest()


def test_rand_reads_the_shake_stream():
    seed = 2 ** 40 + 17
    stream = hashlib.shake_256(struct.pack(">Q", seed)).digest(9000)
    r = Rand(seed)
    assert r.read(5) + r.read(8000) == stream[:8005]
    assert sorted(Rand(3).permutation(124)) == list(range(124))
