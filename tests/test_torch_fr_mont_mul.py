"""The scalar field's multiply (pointwise.cu: fr_mont_mul_kernel), checked
on the CPU.

A CUDA kernel runs only on a card. This file holds a model of the kernel's
launch (one element a thread, blocks of kMulThreads, grid-stride beyond
kMaxBlocks blocks, both read from the source's text): every element is
written once, from a[i * a_stride] and b[i * b_stride], at every stride
pair the wrapper passes. It holds the wrapper's contract on the CPU (where
it runs the plain version fr.mul_plain) against a * b / 2^256 mod r in
Python integers: raw first operands below 2^256 (r and its neighbours, 2r,
2^256 - 1) against every edge element, pairs and one element broadcast on
either side. Tolerance 0. A `cuda` twin runs the kernel on the card at
every size of the device prove's histogram.
"""

import random
import re
from pathlib import Path

import pytest
import torch

from go_curdleproofs_tpu_torch.ops import fr, kernels
from go_curdleproofs_tpu_torch.utils import field_host as fh

torch.set_num_threads(1)
R = fh.R
M32 = (1 << 32) - 1
W = fr.NWORDS
R_INV = pow(1 << (32 * W), -1, R)
POINTWISE = (Path(kernels.__file__).resolve().parent
             / "csrc" / "pointwise.cu").read_text()
THREADS = int(re.search(r"constexpr int kMulThreads = (\d+);",
                        POINTWISE).group(1))
MAX_BLOCKS = eval(re.search(r"constexpr int kMaxBlocks = ([\d *]+);",
                            POINTWISE).group(1))


def _body(signature: str) -> str:
    start = POINTWISE.index(signature)
    return POINTWISE[start:POINTWISE.index("\n}\n", start)]


KERNEL = _body("fr_mont_mul_kernel(const Fr*")
LAUNCHER = _body("int curdle_fr_mont_mul(")


def words(v):
    return [(v >> (32 * j)) & M32 for j in range(W)]


def value(ws):
    return sum(w << (32 * j) for j, w in enumerate(ws))


def fr_edge_elements():
    """Canonical edges: ends of the range, R mod r and R^2 mod r, powers of
    two around word boundaries, words of zeros and of ones."""
    rng = random.Random(7)
    vals = [0, 1, 2, R - 1, R - 2, (R + 1) // 2, (1 << 256) % R,
            (1 << 512) % R]
    for k in (31, 32, 63, 64, 127, 128, 191, 192, 223, 224, 253):
        vals += [1 << k, (1 << k) - 1]
    for j in (0, 1, 3, 4, 6, 7):
        for fill in (0, M32):
            ws = words(rng.randrange(R))
            ws[j] = fill
            if j == W - 1 and fill:
                ws = [M32] * (W - 1) + [(R >> 224) - 1]
            vals.append(value(ws))
    assert all(0 <= v < R for v in vals)
    return vals


EDGE = fr_edge_elements()
# raw first operands: r and its neighbours, 2r, and the top of 2^256
RAW = [R, R + 1, 2 * R - 1, 2 * R, 2 * R + 1, (1 << 256) - 1, (1 << 256) - 2,
       1 << 255, (1 << 256) - R]
# the stride pairs the wrapper passes: pairs, one a for all, one b for all
SIDES = {"pairs": (1, 1), "a broadcast": (0, 1), "b broadcast": (1, 0)}


def _tensor(vals):
    return torch.tensor([[w - (1 << 32) if w >> 31 else w for w in words(v)]
                         for v in vals], dtype=torch.int32)


def _values(t):
    return [value([w & M32 for w in row])
            for row in t.reshape(-1, W).tolist()]


def _operands(avals, bvals, side):
    sa, sb = SIDES[side]
    return (_tensor(avals) if sa else _tensor(avals[:1])[0],
            _tensor(bvals) if sb else _tensor(bvals[:1])[0])


def test_kernel_is_read_from_the_source():
    """One warp a block, one element a thread: the raw a brought below r,
    then the product, launched at kMulThreads with blocks_for."""
    assert W == 8 and THREADS == 32
    assert "__launch_bounds__(kMulThreads)" in POINTWISE
    assert KERNEL.index("curdle::fr_from_raw(x, a[i * a_stride]);") \
        < KERNEL.index("curdle::fr_mul(r, x, y);")
    assert "const Fr y = b[i * b_stride];" in KERNEL
    assert "blocks_for(n, kMulThreads), kMulThreads" in LAUNCHER
    assert RAW[-1] < 1 << 256 and (1 << 256) < 3 * R


def launch(n, a_stride, b_stride):
    """fr_mont_mul_kernel's index arithmetic: {element: (a index, b
    index)} over the grid curdle_fr_mont_mul launches."""
    blocks = min((n + THREADS - 1) // THREADS, MAX_BLOCKS)
    step = blocks * THREADS
    written = {}
    for gid in range(blocks * THREADS):
        for i in range(gid, n, step):
            assert i not in written, i
            written[i] = (i * a_stride, i * b_stride)
    return written


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("n", [1, 3, 31, 32, 33, 1025,
                               MAX_BLOCKS * THREADS + 37])
def test_launch_writes_each_element_once(n, side):
    sa, sb = SIDES[side]
    written = launch(n, sa, sb)
    assert sorted(written) == list(range(n))
    assert all(v == (i * sa, i * sb) for i, v in written.items())


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("a", RAW + [0, R - 1], ids=hex)
def test_raw_first_operands_on_the_edge_grid(a, side):
    """Raw a (and 0, r - 1) against every edge element as b, through the
    wrapper, against Python ints."""
    sa, sb = SIDES[side]
    avals = [a] * len(EDGE) if sa else [a]
    bvals = EDGE if sb else EDGE[:1]
    got = _values(kernels.fr_mont_mul(*_operands(avals, bvals, side)))
    n = max(len(avals), len(bvals))
    assert got == [avals[i * sa] * bvals[i * sb] * R_INV % R
                   for i in range(n)]


@pytest.mark.parametrize("side", list(SIDES))
def test_random_pairs_against_ints(side):
    """1,000 seeded pairs, half with raw first operands, through the
    wrapper, against Python ints."""
    rng = random.Random(31 + len(side))
    avals = [rng.randrange(1 << 256 if i % 2 else R) for i in range(1000)]
    bvals = [rng.randrange(R) for _ in range(1000)]
    sa, sb = SIDES[side]
    got = _values(kernels.fr_mont_mul(*_operands(avals, bvals, side)))
    assert got == [avals[i * sa] * bvals[i * sb] * R_INV % R
                   for i in range(1000)]


# -- on the card -----------------------------------------------------------------

# elements a launch of fr_mont_mul in an ELL=124 device prove
# (chip_smoke.py's histogram on the card)
DEVICE_PROVE_SIZES = (1, 2, 3, 4, 8, 16, 32, 64, 66, 96, 98, 112, 114, 120,
                      122, 124, 126, 127, 128, 129, 256, 384, 512)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fr_mont_mul_at_device_prove_sizes(cuda_device):
    """fr_mont_mul on the card at every size of the device prove's
    histogram, raw first operands, pairs and one element broadcast on
    either side, and the raw edge grid: exact against the plain version,
    one launch a call."""
    rng = random.Random(29)
    for n in DEVICE_PROVE_SIZES:
        a = _tensor([rng.choice(RAW) if i % 4 == 0
                     else rng.randrange(1 << 256)
                     for i in range(n)]).to(cuda_device)
        b = _tensor([rng.randrange(R) for _ in range(n)]).to(cuda_device)
        for x, y in ((a, b), (a, b[-1].contiguous()),
                     (a[0].contiguous(), b)):
            kernels.reset_launches()
            assert torch.equal(kernels.fr_mont_mul(x, y),
                               kernels.fr_mont_mul_plain(x, y)), n
            assert kernels.launches["fr_mont_mul"] == 1
    a = _tensor([u for u in EDGE + RAW for _ in EDGE]).to(cuda_device)
    b = _tensor([v for _ in EDGE + RAW for v in EDGE]).to(cuda_device)
    assert torch.equal(kernels.fr_mont_mul(a, b),
                       kernels.fr_mont_mul_plain(a, b))
