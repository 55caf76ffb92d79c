"""What the output check must catch, planted under the timed path.

Each plant replaces one of the program's entry points that a driver calls
for the length of a `with` block:

* `control`: the reference in the program's place with one stated
  guarantee broken. The verifiers answer from the reference's verify with
  its final sum skipped (soundness gone); the prover runs the program's own
  prove on a Rand of another seed (the request's shuffle gone).
* `flip`: an answer altered where it is produced: every verdict negated,
  or one byte of every proof flipped.
* `unchanged`: a step that returns its state unchanged: the prover hands
  back the pre-trackers as the post-trackers; a verifier answers True
  without looking.
* `half_batch`: a batch verified over its first half only.

A sound run has `correct` true; a run under any plant its kind lists must
have it false (tests/test_bench_drivers.py on the CPU, control.py on the
card).
"""

from __future__ import annotations

import contextlib
import itertools
import random

from go_curdleproofs_tpu_torch.models import whisk
from go_curdleproofs_tpu_torch.parallel import batch as pbatch
from go_curdleproofs_tpu_torch.utils.rand import Rand

from .core.chain import tracker_bytes
from .core.seeds import derive
from .reference import bls, curdleproofs

# the plants that a mix's kind can meet
PLANTS = {
    "verify_stream": ("control", "flip", "unchanged"),
    "sync_batch": ("control", "flip", "unchanged", "half_batch"),
    "prove_chain": ("control", "flip", "unchanged"),
}


def _reference_verifier(drv):
    crs = curdleproofs.make_crs(drv.ell, drv.crs_seed)
    decode = bls.Decoder()

    def verify(pre, post, proof):
        return curdleproofs.verify_shuffle(
            crs, tracker_bytes(pre), tracker_bytes(post), proof, decode,
            random.Random(0), final_check=False)
    return verify


def _replacement(kind: str, name: str, drv):
    """(owner, attribute, function in the program's place)."""
    if kind == "verify_stream":
        real = whisk.is_valid_whisk_shuffle_proof
        if name == "control":
            ref = _reference_verifier(drv)
            fn = lambda crs, pre, post, proof, rand, *, device: \
                ref(pre, post, proof)
        elif name == "flip":
            fn = lambda *a, **k: not real(*a, **k)
        else:
            fn = lambda *a, **k: True
        return whisk, "is_valid_whisk_shuffle_proof", fn
    if kind == "sync_batch":
        real = pbatch.verify_shuffle_proofs_batch
        if name == "control":
            ref = _reference_verifier(drv)
            fn = lambda crs, instances, rand, *, device, group=None: all(
                ref(*inst) for inst in instances)
        elif name == "flip":
            fn = lambda *a, **k: not real(*a, **k)
        elif name == "half_batch":
            fn = lambda crs, instances, *a, **k: real(
                crs, list(instances)[:len(instances) // 2], *a, **k)
        else:
            fn = lambda *a, **k: True
        return pbatch, "verify_shuffle_proofs_batch", fn
    real = whisk.generate_whisk_shuffle_proof
    if name == "control":
        count = itertools.count()

        def fn(crs, pre, rand, **kw):
            return real(crs, pre, Rand(derive(drv.ctx.seed, "control",
                                              next(count))), **kw)
    elif name == "flip":
        def fn(*a, **kw):
            post, proof = real(*a, **kw)
            return post, proof[:60] + bytes([proof[60] ^ 1]) + proof[61:]
    else:
        def fn(crs, pre, rand, **kw):
            _, proof = real(crs, pre, rand, **kw)
            return list(pre), proof
    return whisk, "generate_whisk_shuffle_proof", fn


@contextlib.contextmanager
def plant(kind: str, name: str, drv):
    if name not in PLANTS[kind]:
        raise ValueError(f"{kind} has no plant {name!r}")
    owner, attr, fn = _replacement(kind, name, drv)
    saved = getattr(owner, attr)
    setattr(owner, attr, fn)
    try:
        yield
    finally:
        setattr(owner, attr, saved)
