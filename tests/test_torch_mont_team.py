"""The pointwise Fp multiply B1 (pointwise.cu: mont_mul_kernel) on a team of
lanes (ops/csrc/fp_team.cuh: team_mul), checked on the CPU.

A CUDA kernel runs only on a card. This file holds a lane-by-lane model of
team_mul over Python integers: each lane's K = 12 / T words, each shuffle
and ballot of the team, every lazy carry and its resolution. word_lane,
word_slot and carries_in are read from the header's text and evaluated
here, and the order of the shuffles and ballots in the model is the order
in which team_mul's text calls them, so an edit of the header that changes
the schedule changes the model. The model fails on a 64-bit sum that
overflows, on a lazy carry above its bound, and on a carry or borrow that
leaves the team's top lane. It is held against a * b / 2^384 mod p on
every pair of the edge elements and on 2,000 seeded random pairs, at both
team sizes, with b in registers (a broadcast operand) and by shuffles, and
against the plain version mont_mul_plain word for word. Tolerance 0.

A model of the launch (mont_mul_kernel's index arithmetic, the launcher's
operand swap and its choice between a team and one thread an element)
checks that every element is written once, each word by the lane that
holds it, that a team past the batch reads a copy and stores nothing,
that threads and warps stride whole beyond the grid's kMaxBlocks blocks,
and that every lane of a warp runs the same steps, as the team's
warp-wide shuffles and ballots need.
"""

import random
import re
from collections import defaultdict
from pathlib import Path

import pytest
import torch

from go_curdleproofs_tpu_torch.ops import kernels
from go_curdleproofs_tpu_torch.utils import field_host as fh

torch.set_num_threads(1)
P = fh.P
NW = 12
M32 = (1 << 32) - 1
M64 = (1 << 64) - 1
R_INV = pow(1 << 384, -1, P)
CSRC = Path(kernels.__file__).resolve().parent / "csrc"
TEAM = (CSRC / "fp_team.cuh").read_text()
POINTWISE = (CSRC / "pointwise.cu").read_text()
FP_CUH = (CSRC / "fp.cuh").read_text()


def _body(src: str, signature: str) -> str:
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


def _return_expr(name: str) -> str:
    """The C expression that a one-line helper of fp_team.cuh returns."""
    m = re.search(name + r"\([^)]*\)\s*\{\s*return ([^;]+);", TEAM)
    return m.group(1)


def _c_int_expr(expr: str):
    """A C expression on non-negative ints as a Python function of its
    free names (C's / on them is Python's //)."""
    py = expr.replace("/", "//")
    return lambda **names: eval(py, {}, names)


WORD_LANE = _c_int_expr(_return_expr("word_lane"))
WORD_SLOT = _c_int_expr(_return_expr("word_slot"))
CARRIES_IN = _c_int_expr(_return_expr("carries_in"))
M0 = int(re.search(r"kTeamM0 = (0x[0-9a-f]+)u", TEAM).group(1), 16)
P_WORDS = [int(h, 16) for h in re.findall(
    r"0x([0-9a-f]+)u", re.search(r"kP\[NW\] = \{([^}]*)\}", FP_CUH).group(1))]
MUL_THREADS = int(re.search(r"#define MUL_THREADS (\d+)",
                            POINTWISE).group(1))
MAX_BLOCKS = eval(re.search(r"constexpr int kMaxBlocks = ([\d *]+);",
                            POINTWISE).group(1))
MUL_TEAM = int(re.search(r"#define MUL_TEAM (\d+)", POINTWISE).group(1))
MUL_TEAM_MAX = int(re.search(r"#define MUL_TEAM_MAX (\d+)",
                             POINTWISE).group(1))
TEAMS = (2, 4)
# team_mul's calls of the warp intrinsics, in the order of its text
INTRINSICS = re.findall(r"__shfl_\w*sync|team_ballot\(",
                        _body(TEAM, "__device__ __forceinline__ void team_mul("))


def words(v):
    return [(v >> (32 * j)) & M32 for j in range(NW)]


def value(ws):
    return sum(w << (32 * j) for j, w in enumerate(ws))


class Team:
    """T lanes of one team: shuffles with width T and the team's ballot
    bits, each call logged for the check of the schedule's order."""

    def __init__(self, T):
        self.T = T
        self.calls = []

    def shfl(self, vals, src):
        self.calls.append("__shfl_sync")
        return [vals[src % self.T] for _ in range(self.T)]

    def shfl_down(self, vals):
        """__shfl_down_sync by 1: the top lane reads its own value."""
        self.calls.append("__shfl_down_sync")
        return [vals[t + 1] if t + 1 < self.T else vals[t]
                for t in range(self.T)]

    def shfl_up(self, vals):
        """__shfl_up_sync by 1: lane 0 reads its own value."""
        self.calls.append("__shfl_up_sync")
        return [vals[t - 1] if t > 0 else vals[t] for t in range(self.T)]

    def ballot(self, preds):
        self.calls.append("team_ballot(")
        return sum(1 << t for t, v in enumerate(preds) if v)


def _u64(x):
    if not 0 <= x <= M64:
        raise OverflowError(f"64-bit sum out of range: {x:#x}")
    return x


def team_mul(T, a, b, whole):
    """fp_team.cuh team_mul, statement by statement on T lanes. a, b: 12
    words each. Returns (12 result words, the team's call log)."""
    K = NW // T
    team = Team(T)
    A = [[a[t * K + j] for j in range(K)] for t in range(T)]
    Pw = [[P_WORDS[t * K + j] for j in range(K)] for t in range(T)]
    B = [list(b) if whole else [b[t * K + j] for j in range(K)]
         for t in range(T)]
    w = [[0] * K for _ in range(T)]
    c = [0] * T
    for i in range(NW):
        if whole:
            bi = [B[t][i] for t in range(T)]
        else:
            bi = team.shfl([B[t][WORD_SLOT(i=i, k=K)] for t in range(T)],
                           WORD_LANE(i=i, k=K))
        s = [0] * T
        for j in range(K):
            for t in range(T):
                s[t] = _u64(A[t][j] * bi[t] + w[t][j] + (s[t] >> 32))
                w[t][j] = s[t] & M32
        for t in range(T):
            c[t] = _u64(c[t] + (s[t] >> 32))
        q = team.shfl([(w[t][0] * M0) & M32 for t in range(T)], 0)
        s = [0] * T
        for j in range(K):
            for t in range(T):
                s[t] = _u64(q[t] * Pw[t][j] + w[t][j] + (s[t] >> 32))
                w[t][j] = s[t] & M32
        for t in range(T):
            c[t] = _u64(c[t] + (s[t] >> 32))
        assert w[0][0] == 0, "the Montgomery step clears word 0"
        up = team.shfl_down([w[t][0] for t in range(T)])
        for t in range(T):
            c[t] = _u64(c[t] + (0 if t == T - 1 else up[t]))
            w[t] = w[t][1:] + [c[t] & M32]
            c[t] >>= 32
            assert c[t] <= 3, f"lazy carry {c[t]} after row {i}"
    assert c[T - 1] == 0, "the top lane's lazy carry is 0"
    w = resolve_carries(team, w, c)
    r = reduce_p(team, w, Pw)
    return [x for lane in r for x in lane], team.calls


def resolve_carries(team, w, c):
    """team_mul after its last row: lane t's lazy carry c[t] goes into lane
    t + 1's word 0; the carries that makes are looked ahead by two
    ballots."""
    T, K = team.T, len(w[0])
    w = [list(lane) for lane in w]
    cin = team.shfl_up([c[t] & M32 for t in range(T)])
    s = [0 if t == 0 else cin[t] for t in range(T)]
    ones = [True] * T
    for j in range(K):
        for t in range(T):
            s[t] += w[t][j]
            w[t][j] = s[t] & M32
            s[t] >>= 32
            ones[t] = ones[t] and w[t][j] == M32
    gen = team.ballot([v != 0 for v in s])
    pas = team.ballot(ones)
    assert gen & pas == 0, "a lane that carries out cannot pass one on"
    carries = CARRIES_IN(g=gen, p=pas) & M32
    assert carries >> T & 1 == 0, "a carry left the team's top lane"
    s = [(carries >> t) & 1 for t in range(T)]
    for j in range(K):
        for t in range(T):
            s[t] += w[t][j]
            w[t][j] = s[t] & M32
            s[t] >>= 32
    # what a lane carried out, in either pass, is what the lookahead gave
    # the next lane
    assert [(gen >> t) & 1 | s[t] for t in range(T)] \
        == [(carries >> (t + 1)) & 1 for t in range(T)]
    return w


def reduce_p(team, w, Pw):
    """team_mul's last step: w - p with its borrows looked ahead by two
    ballots; the borrow out of the top lane keeps w."""
    T, K = team.T, len(w[0])
    d = [[0] * K for _ in range(T)]
    br = [0] * T
    zero = [True] * T
    for j in range(K):
        for t in range(T):
            v = (w[t][j] - Pw[t][j] - br[t]) & M64
            d[t][j] = v & M32
            br[t] = v >> 63
            zero[t] = zero[t] and d[t][j] == 0
    bgen = team.ballot([v != 0 for v in br])
    bpass = team.ballot(zero)
    assert bgen & bpass == 0
    borrows = CARRIES_IN(g=bgen, p=bpass) & M32
    br = [(borrows >> t) & 1 for t in range(T)]
    for j in range(K):
        for t in range(T):
            v = (d[t][j] - br[t]) & M64
            d[t][j] = v & M32
            br[t] = v >> 63
    below = (borrows >> T) & 1
    return [w[t] if below else d[t] for t in range(T)]


def _lanes(v, T):
    K = NW // T
    ws = words(v)
    return [ws[t * K:(t + 1) * K] for t in range(T)]


def edge_elements():
    """The chip's edge grid: ends of the range, R and R^2, powers of two
    and their predecessors around word boundaries, and per word one element
    with that word all zeros and one with it all ones."""
    rng = random.Random(5)
    vals = [0, 1, 2, P - 1, P - 2, (P + 1) // 2, (1 << 384) % P,
            (1 << 768) % P, (1 << 380) - 1]
    for k in (31, 32, 33, 63, 64, 95, 96, 191, 192, 351, 352):
        vals += [1 << k, (1 << k) - 1]
    for j in (0, 2, 3, 5, 6, 8, 9, 11):
        for fill in (0, M32):
            ws = words(rng.randrange(P))
            ws[j] = fill
            if j == NW - 1 and fill:
                ws = [M32] * (NW - 1) + [(P >> 352) - 1]
            vals.append(value(ws))
    assert all(0 <= v < P for v in vals)
    return vals


EDGE = edge_elements()


def random_pairs(n=2000, seed=13):
    rng = random.Random(seed)
    return [(rng.randrange(P), rng.randrange(P)) for _ in range(n)]


def _tensor(vals):
    """[n, 12] int32 words of values below p, taken as they are."""
    return torch.tensor([[w - (1 << 32) if w >> 31 else w for w in words(v)]
                         for v in vals], dtype=torch.int32)


def _values(t):
    return [value([w & M32 for w in row]) for row in t.tolist()]


def test_schedule_is_read_from_the_header():
    """The tables and helpers the model evaluates, and the order of the
    intrinsics, come from fp_team.cuh; the kernel runs on the header."""
    assert M0 == (-pow(P, -1, 1 << 32)) & M32
    assert value(P_WORDS) == P
    assert [WORD_LANE(i=i, k=3) for i in range(NW)] == [i // 3
                                                        for i in range(NW)]
    assert INTRINSICS == ["__shfl_sync", "__shfl_sync", "__shfl_down_sync",
                          "__shfl_up_sync"] + ["team_ballot("] * 4
    assert "curdle::team_mul<T, kWhole>" in POINTWISE
    assert "fp_team.cuh" in kernels._SOURCES
    assert MUL_TEAM in (1, 2, 4) and MUL_THREADS % 32 == 0
    # the launcher: the team form up to MUL_TEAM_MAX elements
    assert team_size(1) == MUL_TEAM and team_size(MUL_TEAM_MAX + 1) == 1
    assert "if (n <= MUL_TEAM_MAX)" in POINTWISE


@pytest.mark.parametrize("T", TEAMS)
def test_lane_calls_follow_the_header(T):
    """The model's shuffles and ballots in the order of team_mul's text: a
    row's b_i shuffle, q shuffle and shift; the carry hand-over; the two
    lookaheads."""
    _, calls = team_mul(T, words(3), words(5), whole=False)
    head = INTRINSICS[:3]
    assert calls[:3 * NW] == head * NW
    assert calls[3 * NW:] == INTRINSICS[3:]
    _, calls = team_mul(T, words(3), words(5), whole=True)
    assert calls == head[1:] * NW + INTRINSICS[3:]


@pytest.mark.parametrize("T", TEAMS)
def test_carries_in_is_a_ripple_carry(T):
    """carries_in on every (generate, pass) pair of T lanes, against a
    ripple of the carries lane by lane."""
    for g in range(1 << T):
        for p in range(1 << T):
            if g & p:
                continue
            want, carry = 0, 0
            for t in range(T + 1):
                want |= carry << t
                if t < T:
                    carry = (g >> t) & 1 | ((p >> t) & 1 & carry)
            assert CARRIES_IN(g=g, p=p) & ((2 << T) - 1) == want


@pytest.mark.parametrize("whole", [False, True], ids=["shuffled", "whole"])
@pytest.mark.parametrize("T", TEAMS)
def test_team_model_on_the_edge_grid(T, whole):
    """Every pair of the edge elements, against Python ints."""
    for a in EDGE:
        wa = words(a)
        for b in EDGE:
            got, _ = team_mul(T, wa, words(b), whole)
            assert value(got) == a * b * R_INV % P, (T, hex(a), hex(b))


@pytest.mark.parametrize("T", TEAMS)
def test_team_model_on_random_pairs_and_plain(T):
    """2,000 seeded random pairs against Python ints and, word for word,
    the plain version the kernel is held against on the card."""
    pairs = random_pairs()
    got = [value(team_mul(T, words(a), words(b), whole=i % 2 == 0)[0])
           for i, (a, b) in enumerate(pairs)]
    assert got == [a * b * R_INV % P for a, b in pairs]
    plain = kernels.mont_mul_plain(_tensor([a for a, _ in pairs]),
                                   _tensor([b for _, b in pairs]))
    assert _values(plain) == got


@pytest.mark.parametrize("T", TEAMS)
def test_carry_lookahead_on_crafted_lanes(T):
    """The resolution after the last row on lane words that make carries
    ripple: lanes all ones, all ones but the low word, zero, random; every
    lazy carry 0-3 below the top lane. Against the big-int sum."""
    K = NW // T
    rng = random.Random(17 + T)
    fills = [[M32] * K, [M32 - 2] + [M32] * (K - 1), [0] * K,
             [M32] * (K - 1) + [0]]
    hit = 0
    for _ in range(400):
        w = [list(rng.choice(fills)) if rng.random() < 0.8 else
             [rng.getrandbits(32) for _ in range(K)] for _ in range(T)]
        w[T - 1][K - 1] &= 0x3fffffff           # the sum stays below 2^382
        c = [rng.randrange(4) for _ in range(T - 1)] + [0]
        want = sum((value(w[t]) + (c[t] << (32 * K))) << (32 * K * t)
                   for t in range(T))
        if want >> 384:
            continue
        team = Team(T)
        got = resolve_carries(team, w, c)
        assert value([x for lane in got for x in lane]) == want
        hit += any(all(x == M32 for x in lane) for lane in w[1:T - 1])
    # with two lanes nothing can pass a carry on: lane 0 takes none in
    assert hit > 50 or T == 2


@pytest.mark.parametrize("T", TEAMS)
def test_subtraction_lookahead_on_crafted_values(T):
    """The conditional subtraction at and around p, with lanes equal to
    p's lanes (a borrow passes through them) and lanes of zeros."""
    Pw = _lanes(P, T)
    vals = [0, 1, P - 1, P, P + 1, 2 * P - 1, 2 * P - 2]
    K = NW // T
    for t in range(T):           # p with lane t one more or one less
        for delta in (-1, 1):
            vals.append(P + (delta << (32 * K * t)))
    for t in range(T):           # lanes below t zero, the rest p's
        vals.append(P >> (32 * K * t) << (32 * K * t))
    rng = random.Random(T)
    vals += [rng.randrange(2 * P) for _ in range(200)]
    for v in vals:
        if not 0 <= v < 2 * P:
            continue
        got = reduce_p(Team(T), _lanes(v, T), Pw)
        assert value([x for lane in got for x in lane]) == v % P, hex(v)


# -- the launch ------------------------------------------------------------------

def team_size(n):
    """curdle_mont_mul's choice: MUL_TEAM lanes an element up to
    MUL_TEAM_MAX elements, one thread an element above."""
    return MUL_TEAM if n <= MUL_TEAM_MAX else 1


def launch(n, a_stride, b_stride, T):
    """curdle_mont_mul's operand swap and mont_mul_kernel's index
    arithmetic at T lanes an element. Returns ({element: {word: (lane id,
    a index, b index)}}, whole, swapped)."""
    swapped = a_stride == 0 and b_stride != 0
    if swapped:
        a_stride, b_stride = b_stride, 0
    whole = b_stride == 0
    per_block = MUL_THREADS // T
    blocks = min((n + per_block - 1) // per_block, MAX_BLOCKS)
    written = defaultdict(dict)
    steps = {}
    for blk in range(blocks):
        for x in range(MUL_THREADS):
            lane, gid = x & 31, blk * MUL_THREADS + x
            t = lane & (T - 1)
            seq = []
            if T == 1:                      # one thread an element
                starts = range(gid, n, blocks * MUL_THREADS)
                pairs = [(i, i) for i in starts]
            else:                           # a warp steps as a whole
                per_warp = 32 // T
                starts = range(gid // 32 * per_warp, n,
                               blocks * (MUL_THREADS // 32) * per_warp)
                pairs = [(base + lane // T, base) for base in starts]
            for i, step in pairs:
                seq.append(step)
                ic = min(i, n - 1)          # a team past n reads a copy
                assert 0 <= ic < n
                if i >= n:
                    continue                # ... and stores nothing
                for j in range(NW // T):
                    word = t * (NW // T) + j
                    assert word not in written[i], (i, word)
                    written[i][word] = ((blk, x), ic * a_stride,
                                        0 if whole else ic)
            steps[blk, x] = seq
    # the team kernel's shuffles and ballots name the whole warp: every
    # lane of a warp runs the same steps
    if T > 1:
        for (blk, x), seq in steps.items():
            assert steps[blk, x - (x & 31)] == seq
    return written, whole, swapped


@pytest.mark.parametrize("T", (1,) + TEAMS)
@pytest.mark.parametrize("n", [1, 3, 31, 33, 1025])
def test_launch_writes_each_element_once(T, n):
    written, _, _ = launch(n, 1, 1, T)
    assert sorted(written) == list(range(n))
    for i, ws in written.items():
        assert sorted(ws) == list(range(NW))


@pytest.mark.parametrize("T", (1,) + TEAMS)
def test_launch_beyond_the_grid_strides_whole_teams(T):
    """Above kMaxBlocks blocks the threads, or the warps of teams, stride
    on by the grid."""
    n = MAX_BLOCKS * (MUL_THREADS // T) + 37
    written, _, _ = launch(n, 1, 1, T)
    assert len(written) == n
    assert all(len(ws) == NW for ws in written.values())
    assert written[n - 1][0][0] == written[36][0][0]    # the same lane


@pytest.mark.parametrize("T", TEAMS)
def test_launch_model_products_with_strides(T):
    """The whole kernel on the model at n = 1, T - 1 and 33 with each stride
    pair the wrapper passes (a broadcast a goes to b), against the plain
    version."""
    rng = random.Random(T)
    for n in (1, T - 1, 33):
        avals = [rng.randrange(P) for _ in range(n)]
        bvals = [rng.randrange(P) for _ in range(n)]
        for sa, sb in ((1, 1), (0, 1), (1, 0)):
            written, whole, swapped = launch(n, sa, sb, T)
            assert whole == (0 in (sa, sb)) and swapped == (sa == 0)
            x, y = (bvals, avals) if swapped else (avals, bvals)
            out = []
            for i in range(n):
                (ai, bi), = {v[1:] for v in written[i].values()}
                out.append(value(team_mul(T, words(x[ai]), words(y[bi]),
                                          whole)[0]))
            ta = _tensor(avals if sa else avals[:1])
            tb = _tensor(bvals if sb else bvals[:1])
            want = kernels.mont_mul_plain(ta[0] if not sa else ta,
                                          tb[0] if not sb else tb)
            assert out == _values(want.reshape(-1, NW)), (n, sa, sb)
