"""The port's scalar field (go_curdleproofs_tpu_torch/ops/fr.py), its Fr
ladder (the plain version of kernel B8) and its device digit recoding
(ops/glv_dev.py) against the JAX package's ops/fr.py, limb_kernels.pow_fixed
in interpret mode, ops/glv_dev.py and Python ints, by value. Integer
arithmetic on both sides: the tolerance is none."""

import random
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from go_curdleproofs_tpu.ops import fr as jfr
from go_curdleproofs_tpu.ops import glv_dev as jglv_dev
from go_curdleproofs_tpu.ops import limb_kernels
from go_curdleproofs_tpu.utils.field_host import R
from go_curdleproofs_tpu_torch import convert
from go_curdleproofs_tpu_torch.ops import fr, glv, glv_dev, kernels

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _operands(n=28, seed=5):
    rng = random.Random(seed)
    xs = [0, 1, R - 1, (R + 1) // 2] + [rng.randrange(R) for _ in range(n)]
    ys = [0, R - 1, R - 1, 2] + [rng.randrange(R) for _ in range(n)]
    return xs, ys


def _jfr_ints(e):
    return jfr.to_ints(e)


OPS = {
    "add": (fr.add, jfr.add, lambda x, y: (x + y) % R),
    "sub": (fr.sub, jfr.sub, lambda x, y: (x - y) % R),
    "mul": (fr.mul, jfr.mul, lambda x, y: x * y % R),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_binary_ops_match_ints_and_jax_fr(name):
    port_op, jax_op, host_op = OPS[name]
    xs, ys = _operands()
    got = fr.to_ints(port_op(fr.from_ints(xs, CPU), fr.from_ints(ys, CPU)))
    assert got == [host_op(x, y) for x, y in zip(xs, ys)]
    assert got == _jfr_ints(jax_op(jfr.from_ints(xs), jfr.from_ints(ys)))


def test_from_ints_to_ints_neg_and_broadcast_operand():
    xs, ys = _operands()
    a = fr.from_ints(xs, CPU)
    assert fr.to_ints(a) == xs
    assert fr.to_ints(fr.from_ints([R, R + 5, -1], CPU)) == [0, 5, R - 1]
    assert fr.to_ints(fr.neg(a)) == [(-x) % R for x in xs]
    assert fr.to_ints(fr.neg(a)) == _jfr_ints(jfr.neg(jfr.from_ints(xs)))
    one = fr.from_ints([ys[9]], CPU)                     # [1, 8]
    assert fr.to_ints(fr.mul(a, one)) == fr.to_ints(fr.mul(one, a)) \
        == [x * ys[9] % R for x in xs]
    assert fr.to_ints(fr.add(a, one)) == [(x + ys[9]) % R for x in xs]
    assert tuple(fr.mul(one, one).shape) == (1, fr.NWORDS)
    assert fr.is_zero(a).tolist() == [x == 0 for x in xs]


def test_words_are_montgomery_and_fully_reduced():
    xs, ys = _operands(8)
    out = fr.mul(fr.from_ints(xs, CPU), fr.from_ints(ys, CPU))
    words = out.numpy().view(np.uint32).astype(object)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row))
            for row in words]
    assert all(v < R for v in vals)
    assert vals == [x * y % R * (1 << 256) % R for x, y in zip(xs, ys)]


def test_inner_product_and_prefix_products_match_jax_fr():
    xs, ys = _operands(4)                                # 8 lanes
    a, b = fr.from_ints(xs, CPU), fr.from_ints(ys, CPU)
    want = sum(x * y for x, y in zip(xs, ys)) % R
    assert fr.to_ints(fr.inner_product(a, b)) == [want]
    ip = jfr.inner_product(jfr.from_ints(xs), jfr.from_ints(ys))
    assert _jfr_ints(jfr.fmap(lambda t: t[None], ip)) == [want]
    # an odd lane count, and a batch of two inner products at once
    assert fr.to_ints(fr.inner_product(a[:7], b[:7])) == \
        [sum(x * y for x, y in zip(xs[:7], ys[:7])) % R]
    both = fr.inner_product(torch.stack([a, b]), torch.stack([b, b]))
    assert fr.to_ints(both) == [want, sum(y * y for y in ys) % R]

    exp = [1]
    for y in ys[:-1]:
        exp.append(exp[-1] * y % R)
    assert fr.to_ints(fr.prefix_products(b)) == exp
    assert _jfr_ints(jfr.prefix_products(jfr.from_ints(ys))) == exp
    assert fr.to_ints(fr.prefix_products(b[:5])) == exp[:5]


def test_canonical_bytes_and_convert_round_trip():
    xs, _ = _operands()
    a = fr.from_ints(xs, CPU)
    be = fr.canonical_bytes_be(a)
    assert be.dtype == torch.uint8 and tuple(be.shape) == (len(xs), 32)
    assert [bytes(r.tolist()) for r in be] == [x.to_bytes(32, "big")
                                               for x in xs]
    assert fr.to_ints(fr.from_bytes_be(be)) == xs
    # the JAX package's canonical digits are the same bytes, little-endian
    jd = np.asarray(jfr.canonical_digits(jfr.from_ints(xs)))[:, :32]
    assert (jd[:, ::-1].astype(np.uint8) == be.numpy()).all()
    # state carried across: limbs -> words -> limbs, and unreduced limbs
    limbs = convert.fr_to_jax(a)
    assert (limbs == np.asarray(jfr.from_ints(xs).limbs)).all()
    assert fr.to_ints(convert.fr_from_jax(limbs, device=CPU)) == xs
    summed = jfr.add(jfr.from_ints(xs), jfr.from_ints(xs))      # not carried
    assert fr.to_ints(convert.fr_from_jax(np.asarray(summed.limbs),
                                          device=CPU)) \
        == [2 * x % R for x in xs]


def test_fr_pow_fixed_plain_matches_pallas_kernel():
    """B8: the inputs of tests/test_rns_kernels.py's limb-Fr ladder (64-bit
    exponent, interpret mode), plus 0."""
    random.seed(43)
    e = 0xB7E15162_8AED2A6B
    ys = [random.randrange(1, R) for _ in range(4)] + [1, R - 1, 0]
    want = jfr.to_ints(limb_kernels.pow_fixed(jfr.from_ints(ys), e,
                                              jfr.field, interpret=True))
    got = fr.to_ints(kernels.fr_pow_fixed(fr.from_ints(ys, CPU), e))
    assert got == want == [pow(y, e, R) for y in ys]


def test_fr_inverse_ladder_matches_ints():
    xs, _ = _operands(4)
    a = fr.from_ints(xs, CPU)
    want = [pow(x, -1, R) if x else 0 for x in xs]
    assert fr.to_ints(fr.inv(a)) == want
    assert torch.equal(fr.inv(a), kernels.fr_pow_fixed_plain(a, R - 2))


GLV_CASES = {
    "test_glv": (7, 12, [0, 1, R - 1, glv.LAMBDA, glv.LAMBDA * 2 % R]),
    "test_device_stack": (None, 4, []),
    "barrett_edges": (11, 40, [glv.LAMBDA - 1, glv.LAMBDA + 1, R - glv.LAMBDA,
                               glv.LAMBDA * glv.LAMBDA,
                               glv.LAMBDA * (glv.LAMBDA + 1) - 1,
                               (R + 1) // 2, (1 << 254), (1 << 128) - 1]),
}


@pytest.mark.parametrize("case", sorted(GLV_CASES))
def test_glv_split_digits_match_jax_and_host(case):
    seed, n, extra = GLV_CASES[case]
    rng = random.Random(seed)
    vals = [rng.randrange(R) for _ in range(n)] + extra
    got = glv_dev.glv_split_digits(fr.from_ints(vals, CPU))
    assert got.dtype == torch.int32
    assert (got.numpy() == glv.scalars_to_digits_glv(vals)).all()
    want = np.asarray(jax.jit(jglv_dev.glv_split_digits)(jfr.from_ints(vals)))
    assert (convert.digits_to_jax(got) == want).all()
    assert torch.equal(convert.digits_from_jax(want, device=CPU), got)
    # a leading batch axis recodes each row block on its own
    two = glv_dev.glv_split_digits(
        fr.from_ints(vals + vals[::-1], CPU).reshape(2, len(vals), -1))
    assert torch.equal(two[0], got)


def test_fr_cuda_constants_match_field():
    """The immediates of fr_asm.cuh, which fr.cuh wraps: r's words and
    -r^-1 mod 2^32 (the card compiles them; here they are read back and
    checked)."""
    csrc = Path(kernels.__file__).parent / "csrc"
    assert '#include "fr_asm.cuh"' in (csrc / "fr.cuh").read_text()
    asm = (csrc / "fr_asm.cuh").read_text()
    rinvs = set(re.findall(r"mul\.lo\.u32 mi, \w+, (0x[0-9a-f]+);", asm))
    assert len(rinvs) == 1
    rinv = int(rinvs.pop(), 16)
    assert (rinv * R) % (1 << 32) == (1 << 32) - 1
    r_words = {(R >> (32 * j)) & 0xFFFFFFFF for j in range(8)}
    assert {int(h, 16) for h in re.findall(r"0x[0-9a-f]{8}", asm)} \
        == r_words | {rinv}
