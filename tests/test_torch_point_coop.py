"""The schedule under the point kernels B2 (point_add) and B3 (point_double):
the cooperative operations of ops/csrc/point_coop.cuh and the index
arithmetic of ops/csrc/pointwise.cu.

A CUDA kernel runs only on a card, so these tests hold a model of it on the
CPU. The model of coop_add and coop_double runs the header's steps lane by
lane over Python integers (Montgomery words, as the kernels hold them),
with the index tables read from the header's text, so an edit of the header
that changes the schedule changes the model. Between two __syncwarp calls a
shared slot may be written by one lane and then read by no other: the
model's shared memory checks that at every hand-over. The model is held
word for word against point_add_plain / point_double_plain (what the
kernels are compared with on the card) and, normalised, against the host's
group law. The model of the launch checks that every point is written
once and that a group's lanes share its points and its GroupMem.
"""

import re
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch

from go_curdleproofs_tpu_torch.ops import curve, fp, kernels
from go_curdleproofs_tpu_torch.utils import field_host as fh

torch.set_num_threads(1)
CPU = torch.device("cpu")
P = fh.P
R_INV = pow(1 << 384, -1, P)          # the Montgomery product divides by R
CSRC = Path(kernels.__file__).resolve().parent / "csrc"
COOP = (CSRC / "point_coop.cuh").read_text()
POINTWISE = (CSRC / "pointwise.cu").read_text()


def _body(src: str, signature: str) -> str:
    """The text of a function, from its signature to the next top-level
    closing brace."""
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


def _hex(pattern: str, text: str):
    return [int(h, 16) for h in re.findall(pattern, text)]


ADD_SRC = _body(COOP, "void coop_add(")
DOUBLE_SRC = _body(COOP, "void coop_double(")
PAIR_A, PAIR_B = (_hex(rf"{name} = (0x[0-9a-fA-F]+)", ADD_SRC)[0]
                  for name in ("kPairA", "kPairB"))
ADD_R2_U, ADD_R2_V = _hex(r"m\.opd\[pick\((0x[0-9a-fA-F]+), lane\)\]",
                          ADD_SRC)
DBL_R1_U, DBL_R1_V = _hex(r"m\.acc\[pick\((0x[0-9a-fA-F]+), lane\)\]",
                          DOUBLE_SRC)
DBL_R2_U, DBL_R2_V = _hex(r"m\.opd\[pick\((0x[0-9a-fA-F]+), lane\)\]",
                          DOUBLE_SRC)
GROUP_LANES = int(re.search(r"kGroupLanes = (\d+);", COOP).group(1))
POINT_THREADS = int(re.search(r"#define POINT_THREADS (\d+)",
                              POINTWISE).group(1))
MAX_BLOCKS = eval(re.search(r"constexpr int kMaxBlocks = ([\d *]+);",
                            POINTWISE).group(1))


def pick(table: int, lane: int) -> int:
    return (table >> (4 * lane)) & 7


def mul(a, b):
    return a * b * R_INV % P


def add(a, b):
    return (a + b) % P


def sub(a, b):
    return (a - b) % P


class RaceError(AssertionError):
    pass


class GroupMem:
    """One group's shared memory: slots ("acc", k), ("q", k), ("prod", k),
    ("opd", k) holding ints, and the accesses since the last hand-over."""

    def __init__(self):
        self.slots = {}
        self.accesses = []

    def read(self, lane, slot):
        self.accesses.append((lane, "r", slot))
        return self.slots[slot]

    def write(self, lane, slot, value):
        self.accesses.append((lane, "w", slot))
        self.slots[slot] = value

    def syncwarp(self):
        """Between two hand-overs the lanes run side by side: a slot that a
        lane writes must be read or written by no other lane."""
        writer = {}
        for lane, op, slot in self.accesses:
            if op == "w" and writer.setdefault(slot, lane) != lane:
                raise RaceError(f"{slot} written by lanes {writer[slot]} "
                                f"and {lane}")
        for lane, op, slot in self.accesses:
            if slot in writer and writer[slot] != lane:
                raise RaceError(f"{slot} written by lane {writer[slot]} and "
                                f"read by lane {lane} in one step")
        self.accesses = []


def mul3(s):
    return add(add(s, s), s)


def coop_add(m: GroupMem) -> None:
    """point_coop.cuh: coop_add, lane by lane."""
    for lane in range(6):                                   # round 1
        i = lane if lane < 3 else pick(PAIR_A, lane - 3)
        u, v = m.read(lane, ("acc", i)), m.read(lane, ("q", i))
        if lane >= 3:
            j = pick(PAIR_B, lane - 3)
            u = add(u, m.read(lane, ("acc", j)))
            v = add(v, m.read(lane, ("q", j)))
        m.write(lane, ("prod", lane), mul(u, v))
    m.syncwarp()
    for lane in range(6):                                   # linear step
        if lane < 3:
            s = add(m.read(lane, ("prod", pick(PAIR_A, lane))),
                    m.read(lane, ("prod", pick(PAIR_B, lane))))
            s = sub(m.read(lane, ("prod", 3 + lane)), s)
        else:
            s = m.read(lane, ("prod", 0 if lane == 3 else 2))
        if lane >= 2:
            s = mul3(s)
            if lane != 3:
                s = add(s, s)
                s = add(s, s)
        if lane == 4:
            s = add(m.read(lane, ("prod", 1)), s)
        if lane == 5:
            s = sub(m.read(lane, ("prod", 1)), s)
        m.write(lane, ("opd", lane), s)
    m.syncwarp()
    for lane in range(6):                                   # round 2
        u = m.read(lane, ("opd", pick(ADD_R2_U, lane)))
        v = m.read(lane, ("opd", pick(ADD_R2_V, lane)))
        m.write(lane, ("prod", lane), mul(u, v))
    m.syncwarp()
    for lane in range(3):                                   # X3, Y3, Z3
        a = m.read(lane, ("prod", 2 * lane + 1))
        b = m.read(lane, ("prod", 2 * lane))
        m.write(lane, ("acc", lane), sub(a, b) if lane == 0 else add(a, b))
    m.syncwarp()


def coop_double(m: GroupMem) -> None:
    """point_coop.cuh: coop_double, lane by lane."""
    for lane in range(4):                                   # round 1
        u = m.read(lane, ("acc", pick(DBL_R1_U, lane)))
        v = m.read(lane, ("acc", pick(DBL_R1_V, lane)))
        dst = ("opd", 4 + (lane >> 1)) if lane & 1 else ("prod", lane)
        m.write(lane, dst, mul(u, v))
    m.syncwarp()
    for lane in range(4):                                   # linear step
        a = m.read(lane, ("prod", 0 if lane == 1 else 2))
        s = add(a, a)
        if lane != 1:
            s = add(s, a)
        s = add(s, s)
        s = add(s, s)
        if lane == 0:
            s = sub(m.read(lane, ("prod", 0)), mul3(s))
        if lane == 2:
            s = add(m.read(lane, ("prod", 0)), s)
        m.write(lane, ("opd", lane), s)
    m.syncwarp()
    for lane in range(4):                                   # round 2
        u = m.read(lane, ("opd", pick(DBL_R2_U, lane)))
        v = m.read(lane, ("opd", pick(DBL_R2_V, lane)))
        m.write(lane, ("prod", lane), mul(u, v))
    m.syncwarp()
    for lane in range(3):                                   # X3, Y3, Z3
        a = m.read(lane, ("prod", 3 if lane == 2 else lane))
        if lane < 2:
            a = add(a, m.read(lane, ("prod", 2 * lane)))
        m.write(lane, ("acc", lane), a)
    m.syncwarp()


def _words(t: torch.Tensor):
    """The Montgomery words of [..., 12] elements as ints, flattened."""
    return [sum((w & 0xFFFFFFFF) << (32 * j) for j, w in enumerate(row))
            for row in t.reshape(-1, fp.NWORDS).tolist()]


def _coords(pv: curve.PointVec):
    return list(zip(*(_words(t) for t in pv)))


def model_point_op(p: curve.PointVec, q=None):
    """The kernel's work for every point of the batch: lanes 0..2 load P
    (and Q), a hand-over, one operation, lanes 0..2 read the result."""
    out = []
    pairs = zip(_coords(p), _coords(q)) if q is not None else \
        ((c, None) for c in _coords(p))
    for pc, qc in pairs:
        m = GroupMem()
        for lane in range(3):
            m.write(lane, ("acc", lane), pc[lane])
            if qc is not None:
                m.write(lane, ("q", lane), qc[lane])
        m.syncwarp()
        (coop_add if qc is not None else coop_double)(m)
        out.append(tuple(m.read(lane, ("acc", lane)) for lane in range(3)))
    return out


def _affine(c):
    """Montgomery projective words -> host affine (None at Z = 0)."""
    x, y, z = (v * R_INV % P for v in c)
    if z == 0:
        return None
    zi = pow(z, -1, P)
    return x * zi % P, y * zi % P


def _projective(pts, rng, scale: bool) -> curve.PointVec:
    """Host points as a PointVec; with `scale`, each finite point at a
    random Z != 1 (X = x Z, Y = y Z) and infinity as (0 : y : 0), y != 1."""
    cols = ([], [], [])
    for pt in pts:
        z = int(rng.integers(2, 1 << 62)) if scale else 1
        if pt is None:
            c = (0, z, 0)
        else:
            c = (pt[0] * z % P, pt[1] * z % P, z)
        for col, v in zip(cols, c):
            col.append(v)
    return curve.PointVec(*(fp.from_ints(col, CPU) for col in cols))


def _rand_points(rng, n):
    return [fh.g1_mul(fh.G1_GEN, int(rng.integers(1, 1 << 62))
                      * int(rng.integers(1, 1 << 62)) % fh.R)
            for _ in range(n)]


def _add_case(name, rng):
    a, b = _rand_points(rng, 2)
    cases = {"infinity + P": ([None], [a]),
             "P + infinity": ([a], [None]),
             "infinity + infinity": ([None], [None]),
             "P + P": ([a], [a]),
             "P + (-P)": ([a], [fh.g1_neg(a)]),
             "random": (_rand_points(rng, 6), _rand_points(rng, 6))}
    if name == "P + Q, Q + P":
        return [a, b], [b, a]
    return cases[name]


ADD_CASES = ["infinity + P", "P + infinity", "infinity + infinity", "P + P",
             "P + (-P)", "random", "P + Q, Q + P"]


@pytest.mark.parametrize("scale", [False, True], ids=["Z=1", "random Z"])
@pytest.mark.parametrize("case", ADD_CASES)
def test_coop_add_model_matches_plain_and_oracle(case, scale):
    rng = np.random.default_rng(ADD_CASES.index(case) + 10 * scale)
    ps, qs = _add_case(case, rng)
    pv, qv = _projective(ps, rng, scale), _projective(qs, rng, scale)
    got = model_point_op(pv, qv)
    assert got == _coords(kernels.point_add_plain(pv, qv))
    assert [_affine(c) for c in got] == [fh.g1_add(a, b)
                                         for a, b in zip(ps, qs)]


def test_coop_add_model_with_one_tensor_as_both_operands():
    """point_add(p, p): the kernel reads P and Q from the same arrays."""
    rng = np.random.default_rng(7)
    ps = [None] + _rand_points(rng, 3)
    pv = _projective(ps, rng, True)
    got = model_point_op(pv, pv)
    assert got == _coords(kernels.point_add_plain(pv, pv))
    assert got == _coords(kernels.point_double_plain(pv))
    assert [_affine(c) for c in got] == [fh.g1_add(a, a) for a in ps]


@pytest.mark.parametrize("scale", [False, True], ids=["Z=1", "random Z"])
@pytest.mark.parametrize("case", ["infinity", "random"])
def test_coop_double_model_matches_plain_and_oracle(case, scale):
    rng = np.random.default_rng(20 + scale)
    ps = [None] if case == "infinity" else _rand_points(rng, 6)
    pv = _projective(ps, rng, scale)
    got = model_point_op(pv)
    assert got == _coords(kernels.point_double_plain(pv))
    assert [_affine(c) for c in got] == [fh.g1_add(a, a) for a in ps]


def test_model_catches_a_lane_reading_another_lanes_write():
    """The hand-over check itself: a round that wrote its products into
    the slots it reads (as round 2 of an add would if it wrote opd) is a
    race, and so are two writers of one slot."""
    m = GroupMem()
    for k in range(6):
        m.write(0, ("opd", k), k)
    m.syncwarp()
    for lane in range(2):
        m.read(lane, ("opd", pick(ADD_R2_U, lane)))
        m.write(lane, ("opd", lane), 0)
    with pytest.raises(RaceError):
        m.syncwarp()
    m = GroupMem()
    m.write(0, ("acc", 0), 1)
    m.write(1, ("acc", 0), 1)
    with pytest.raises(RaceError):
        m.syncwarp()


def test_schedule_tables_are_read_from_the_header():
    """Each table names slots that exist: products 0..5 of an add, 0..3 of
    a double (its opd 4 and 5 are round-1 products), coordinates 0..2; the
    round-2 pairs of an add are the six products of RCB16 algorithm 7."""
    for lane in range(3):
        assert {pick(PAIR_A, lane), pick(PAIR_B, lane)} <= {0, 1, 2}
        assert pick(PAIR_A, lane) != pick(PAIR_B, lane)
    pairs = {frozenset((pick(ADD_R2_U, k), pick(ADD_R2_V, k)))
             for k in range(6)}
    assert len(pairs) == 6
    assert all(max(pick(t, k) for k in range(4)) <= 2
               for t in (DBL_R1_U, DBL_R1_V))
    assert all(max(pick(t, k) for k in range(4)) <= 5
               for t in (DBL_R2_U, DBL_R2_V))
    # where the model puts a double's round-1 products
    assert ("Fp& dst = (lane & 1) ? m.opd[4 + (lane >> 1)] : m.prod[lane];"
            in DOUBLE_SRC)


def test_no_one_thread_point_formula_is_left():
    """The point kernels run on the cooperative operations; no source in
    ops/csrc keeps a one-thread point formula (a function on a Point, or a
    point formula compiled as a function of its own with a stack frame)."""
    for src in CSRC.glob("*.cu*"):
        text = src.read_text()
        assert "struct Point" not in text, src.name
        assert not re.search(r"__noinline__[^{;]*\bpoint_", text), src.name
    assert "curdle::coop_add(m, lane, mask)" in _body(
        POINTWISE, "point_add_kernel(")
    assert "curdle::coop_double(m, lane, mask)" in _body(
        POINTWISE, "point_double_kernel(")


# -- the launch -------------------------------------------------------------

def test_point_kernels_index_in_64_bits_and_stride_by_whole_groups():
    """The loop of both kernels, as the model below runs it."""
    loop = ("for (long long i = (long long)blockIdx.x * kPointGroups + "
            "group; i < n;\n       i += step)")
    step = "const long long step = (long long)gridDim.x * kPointGroups;"
    for name in ("point_add_kernel(", "point_double_kernel("):
        body = _body(POINTWISE, name)
        assert loop in body and step in body, name
        assert "const int group = threadIdx.x / kGroupLanes;" in body
        assert "GroupMem& m = mem[group];" in body
    assert ("blocks_for(n, kPointGroups), kPointThreads"
            in _body(POINTWISE, "int curdle_point_add("))
    assert ("blocks_for(n, kPointGroups), kPointThreads"
            in _body(POINTWISE, "int curdle_point_double("))
    assert "return 0xffu << (threadIdx.x & 24);" in COOP


def launch_model(n: int, threads: int):
    """Per thread of every block: the points its loop visits. Checks that
    every coordinate of every point is written once, that the lanes of a
    group visit the same points, and that the threads which share
    GroupMem k (group = threadIdx.x / 8) lie in one warp and are exactly
    the lanes of their __syncwarp mask. Returns the number of blocks."""
    assert threads % 32 == 0                    # whole warps a block
    groups = threads // GROUP_LANES
    users = defaultdict(set)
    for t in range(threads):
        users[t // GROUP_LANES].add(t)
    for group, ts in users.items():
        assert len({t // 32 for t in ts}) == 1
        for t in ts:
            mask = (0xFF << (t & 24)) & 0xFFFFFFFF    # group_mask()
            assert mask == sum(1 << (u % 32) for u in ts)
    blocks = min((n + groups - 1) // groups, MAX_BLOCKS)   # blocks_for
    writes = Counter()
    for b in range(blocks):
        for group, ts in users.items():
            seqs = {tuple(range(b * groups + t // GROUP_LANES, n,
                                blocks * groups)) for t in ts}
            assert len(seqs) == 1               # the group strides together
            (seq,) = seqs
            for lane in range(3):               # lanes 0..2 store
                writes.update((i, lane) for i in seq)
    assert writes == Counter({(i, c): 1 for i in range(n) for c in range(3)})
    return blocks


@pytest.mark.parametrize("n", [1, 3, 4, 5, 33, 1025, 4096])
def test_launch_model_at_the_chosen_block(n):
    blocks = launch_model(n, POINT_THREADS)
    assert blocks == -(-n // (POINT_THREADS // GROUP_LANES))


@pytest.mark.parametrize("threads", [32, 64, 128])
def test_launch_model_beyond_the_grid_cap(threads):
    """More points than kMaxBlocks blocks hold: whole groups stride on;
    also the block sizes time_kernels.py --point-threads builds."""
    groups = threads // GROUP_LANES
    n = MAX_BLOCKS * groups + 5
    assert launch_model(n, threads) == MAX_BLOCKS
