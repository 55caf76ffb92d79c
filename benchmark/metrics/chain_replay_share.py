"""chain_replay_share: the share of the port's `chain` spans (the device
prover's whole device chain, models/device_common.py `enqueue`) that a
replay of the chain's CUDA graph served, over the profiled requests, in %:
the counter `chain.replays` (1 for a replay, 0 for an eager chain) over
the number of `chain` spans. Nothing where no `chain` span counts it, as
at a commit whose device prover has no graph."""

from benchmark.core.spans import per_request


def read(data):
    reqs = per_request(data)
    if not reqs:
        return None
    chains = [r for req in reqs for r in req if r.name == "chain"]
    counted = [r.counts["chain.replays"] for r in chains
               if r.counts and "chain.replays" in r.counts]
    if not counted:
        return None
    return 100.0 * sum(counted) / len(chains)
