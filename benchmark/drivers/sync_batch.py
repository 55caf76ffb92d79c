"""sync_batch: a syncing node catching up, verifying `batch` shuffle proofs
in one call.

Each request is `parallel.batch.verify_shuffle_proofs_batch` with no
process group over the set-up chain's proofs in a new seeded order, with a
fresh seeded Rand; in every `reject_every` requests one, at a seeded
place, has its last member paired with another proof's post-trackers, so
that its verdict is False. The check has the reference verify every proof
of the chain and a seeded sample of `check_rejects` of the wrong pairings
the window sent, and compares the verdict of every batch whose members it
verified.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

from go_curdleproofs_tpu_torch.parallel import batch as pbatch
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
        first = chain.first_trackers(self.ell, ctx.seed, ctx.device)
        self.chain = chain.make_chain(self.crs, first, self.t["chain"],
                                      ctx.seed, ctx.device)

    def _members(self, stream: str, i: int) -> List[Tuple[int, int]]:
        seed, n = self.ctx.seed, len(self.chain)
        order = list(range(n))
        random.Random(derive(seed, stream, "order", i)).shuffle(order)
        pairs = [(p, p) for p in order[:self.t["batch"]]]
        every = self.t["reject_every"]
        if i % every == derive(seed, stream, "reject", i // every) % every:
            p = pairs[-1][0]
            pairs[-1] = (p, (p + 1 + derive(seed, stream, "other", i)
                             % (n - 1)) % n)
        return pairs

    def _work(self, pairs) -> Dict:
        blobs = {b for p, q in pairs
                 for t in self.chain[p].pre + self.chain[q].post
                 for b in (t.r_g, t.k_r_g)}
        k = len(pairs)
        return {"decode": len(blobs) + k * roofline.proof_points(self.ell),
                "msm": [roofline.verify_msm_bases(self.ell, len(blobs), k)]}

    def _request(self, stream: str, i: int) -> Request:
        pairs = self._members(stream, i)
        instances = [(self.chain[p].pre, self.chain[q].post,
                      self.chain[p].proof) for p, q in pairs]
        rand_seed = derive(self.ctx.seed, stream, "rand", i)
        crs, dev = self.crs, self.ctx.device

        def run():
            return pbatch.verify_shuffle_proofs_batch(
                crs, instances, Rand(rand_seed), device=dev, group=None)
        return Request(run, len(pairs), self._work(pairs), {"pairs": pairs})

    def warm(self) -> None:
        for i in range(self.t["warm_requests"]):
            self._request("warm", i).run()

    def request(self, i: int) -> Request:
        return self._request("window", i)

    def check(self, done) -> List[Check]:
        answered = [d for d in done if d.error is None]
        wrong = sorted({pq for d in answered for pq in d.meta["pairs"]
                        if pq[0] != pq[1]})
        random.Random(derive(self.ctx.seed, "check")).shuffle(wrong)
        todo = wrong[:self.t["check_rejects"]] + [
            (p, p) for p in range(len(self.chain))]
        ref = dict(zip(todo, reference_answers(
            self.ell, self.crs_seed,
            [chain.verify_job(self.chain[p].pre, self.chain[q].post,
                              self.chain[p].proof,
                              derive(self.ctx.seed, "reference", p, q))
             for p, q in todo], self.ctx.workers)))
        compared = [d for d in answered
                    if all(pq in ref for pq in d.meta["pairs"])]
        mismatches = sum(
            not isinstance(d.answer, bool)
            or d.answer != all(ref[pq] for pq in d.meta["pairs"])
            for d in compared)
        return [Check("verdict_mismatches", mismatches, 0),
                Check("chain_proofs_rejected",
                      sum(not ref[(p, p)] for p in range(len(self.chain))), 0),
                Check("false_batches_compared",
                      sum(not all(ref[pq] for pq in d.meta["pairs"])
                          for d in compared),
                      min(1, self.t["check_rejects"]), at_most=False),
                Check("batches_compared", len(compared), 1, at_most=False)]
