"""prove_chain: one proposer making shuffle proofs block after block.

Each request is `whisk.generate_whisk_shuffle_proof` with the mix's
`prover` on the post-trackers of the request before it (the first on a
tracker set made from the seed), with a fresh seeded Rand; it ends on the
host with the proof bytes and the post-trackers. The check takes a seeded
sample of `check_requests` of the window's requests and has the reference
verify each proof against its pre- and post-trackers and recompute the
shuffle (the permutation and k that the request's Rand draws first) point
by point.
"""

from __future__ import annotations

import random
from typing import List

from go_curdleproofs_tpu_torch.models import whisk
from go_curdleproofs_tpu_torch.utils.rand import Rand

from benchmark.core import chain, roofline
from benchmark.core.check import Check, reference_answers
from benchmark.core.runner import Request
from benchmark.core.seeds import derive


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.ell = ctx.config["ell"]
        self.t = ctx.traffic

    def setup(self) -> None:
        ctx = self.ctx
        self.crs, self.crs_seed = chain.make_crs(self.ell, ctx.seed,
                                                 ctx.device)
        self.first = chain.first_trackers(self.ell, ctx.seed, ctx.device)
        self.pre = self.first

    def _request(self, stream: str, i: int, pre) -> Request:
        rand_seed = derive(self.ctx.seed, stream, "rand", i)
        crs, dev, prover = self.crs, self.ctx.device, self.t["prover"]

        def run():
            return whisk.generate_whisk_shuffle_proof(
                crs, pre, Rand(rand_seed), device=dev, prover=prover)
        return Request(run, 1, roofline.prove_work(self.ell),
                       {"pre": pre, "rand_seed": rand_seed})

    def warm(self) -> None:
        for i in range(self.t["warm_requests"]):
            self._request("warm", i, self.first).run()

    def request(self, i: int) -> Request:
        req = self._request("window", i, self.pre)
        inner = req.run

        def run():
            post, proof = inner()
            self.pre = post
            return post, proof
        req.run = run
        return req

    def check(self, done) -> List[Check]:
        answered = [d for d in done if d.error is None]
        rng = random.Random(derive(self.ctx.seed, "check"))
        sample = rng.sample(answered, min(len(answered),
                                          self.t["check_requests"]))
        malformed = sum(not _well_formed(d.answer, self.ell)
                        for d in answered)
        sample = [d for d in sample if _well_formed(d.answer, self.ell)]
        verdicts = reference_answers(
            self.ell, self.crs_seed,
            [dict(chain.verify_job(d.meta["pre"], d.answer[0], d.answer[1],
                                   derive(self.ctx.seed, "reference",
                                          d.index)),
                  op="check_prove", rand_seed=d.meta["rand_seed"])
             for d in sample], self.ctx.workers)
        return [Check("malformed_outputs", malformed, 0),
                Check("proofs_rejected", sum(not ok for ok, _ in verdicts), 0),
                Check("trackers_not_shuffled",
                      sum(bad for _, bad in verdicts), 0),
                Check("proofs_compared", len(verdicts),
                      min(len(answered), self.t["check_requests"]),
                      at_most=False)]


def _well_formed(answer, ell: int) -> bool:
    """ell post-trackers, and proof bytes of the wire size whose fixed
    array's tail past the encoded proof (10 list lengths, 7 scalars) is
    zero."""
    try:
        post, proof = answer
    except (TypeError, ValueError):
        return False
    content = roofline.proof_points(ell) * 48 + 10 * 4 + 7 * 32
    return (len(post) == ell and isinstance(proof, bytes)
            and len(proof) == whisk.expected_shuffle_proof_size(ell)
            and not any(proof[content:]))
