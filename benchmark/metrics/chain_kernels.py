"""chain_kernels: the port's counter `chain.kernels`, the hand-written
kernel launches that the host enqueues inside a `chain` span (the device
prover's whole device chain), mean a profiled request."""

from benchmark.core.spans import counter, per_request


def read(data):
    total = counter(data, "chain.kernels")
    return None if total is None else total / len(per_request(data))
