"""verify_stream: one client verifying shuffle proofs one after another,
as every node does with each block's proof.

Requests are `whisk.is_valid_whisk_shuffle_proof` on the set-up chain's
proofs, picked from the seed, each with a fresh seeded Rand. In every
block of `reject_every` requests one, at a seeded place, pairs a proof
with the post-trackers of another proof of the chain: well formed, to be
rejected, and as dear as the others (its failure shows only in the final
MSM). The check verifies a seeded sample of the distinct (proof,
post-trackers) pairs that the window sent, `check_accepts` to be accepted
and `check_rejects` to be rejected, with the reference, and compares every
answer the window gave for them.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

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
        self._work: Dict[Tuple[int, int], Dict] = {}

    def setup(self) -> None:
        ctx = self.ctx
        self.crs, self.crs_seed = chain.make_crs(self.ell, ctx.seed,
                                                 ctx.device)
        first = chain.first_trackers(self.ell, ctx.seed, ctx.device)
        self.chain = chain.make_chain(self.crs, first, self.t["chain"],
                                      ctx.seed, ctx.device)

    def _pair(self, stream: str, i: int) -> Tuple[int, int]:
        """(proof index, index of the proof whose post-trackers go with
        it): the same index but for one request a block."""
        seed, n, every = self.ctx.seed, len(self.chain), self.t["reject_every"]
        p = derive(seed, stream, "pick", i) % n
        if i % every != derive(seed, stream, "reject", i // every) % every:
            return p, p
        return p, (p + 1 + derive(seed, stream, "other", i) % (n - 1)) % n

    def _request(self, stream: str, i: int) -> Request:
        p, q = self._pair(stream, i)
        inst, other = self.chain[p], self.chain[q]
        rand_seed = derive(self.ctx.seed, stream, "rand", i)
        crs, dev = self.crs, self.ctx.device

        def run():
            return whisk.is_valid_whisk_shuffle_proof(
                crs, inst.pre, other.post, inst.proof, Rand(rand_seed),
                device=dev)
        return Request(run, 1, self._work_of(p, q), {"pair": (p, q)})

    def _work_of(self, p: int, q: int) -> Dict:
        if (p, q) not in self._work:
            blobs = {b for t in self.chain[p].pre + self.chain[q].post
                     for b in (t.r_g, t.k_r_g)}
            self._work[(p, q)] = {
                "decode": len(blobs) + roofline.proof_points(self.ell),
                "msm": [roofline.verify_msm_bases(self.ell, len(blobs))]}
        return self._work[(p, q)]

    def warm(self) -> None:
        for i in range(self.t["warm_requests"]):
            self._request("warm", i).run()

    def request(self, i: int) -> Request:
        return self._request("window", i)

    def check(self, done) -> List[Check]:
        answered = [d for d in done if d.error is None]
        pairs = sorted({d.meta["pair"] for d in answered})
        rng = random.Random(derive(self.ctx.seed, "check"))
        rng.shuffle(pairs)
        accepts = [pq for pq in pairs if pq[0] == pq[1]]
        rejects = [pq for pq in pairs if pq[0] != pq[1]]
        sample = (rejects[:self.t["check_rejects"]]
                  + accepts[:self.t["check_accepts"]])
        verdicts = dict(zip(sample, reference_answers(
            self.ell, self.crs_seed,
            [chain.verify_job(self.chain[p].pre, self.chain[q].post,
                              self.chain[p].proof,
                              derive(self.ctx.seed, "reference", p, q))
             for p, q in sample], self.ctx.workers)))
        compared = [d for d in answered if d.meta["pair"] in verdicts]
        wrong = sum(not isinstance(d.answer, bool)
                    or d.answer != verdicts[d.meta["pair"]] for d in compared)
        return [Check("verdict_mismatches", wrong, 0),
                Check("chain_proofs_rejected",
                      sum(not v for (p, q), v in verdicts.items() if p == q),
                      0),
                Check("reference_rejects",
                      sum(not v for v in verdicts.values()),
                      min(1, self.t["check_rejects"]), at_most=False),
                Check("verdicts_compared", len(compared),
                      len(sample), at_most=False)]

