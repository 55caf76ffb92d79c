"""Which prover runs: the caller says, nothing else decides.

`prover="host"` is the host-orchestrated prover (the transcript and the Fr
arithmetic on the host, every MSM a device call with its own fetch);
`prover="device"` is the device-resident one-fetch prover
(models/device_prover_full.py, with the folding rounds of
models/device_prover2.py). Both give the same proof bytes. The value is an
argument of `whisk.generate_whisk_shuffle_proof` and `curdleproof.prove`,
and `curdleproof.prove` is where it is read: the sub-arguments' provers
below it are host-orchestrated and take no such argument. No environment
variable is read and nothing switches on the device it finds: `"device"`
on a CPU device runs the same chain on the kernels' plain versions.
"""

from __future__ import annotations

PROVERS = ("host", "device")
DEFAULT_PROVER = "host"


def check_prover(prover: str) -> str:
    if prover not in PROVERS:
        raise ValueError(f"prover must be one of {PROVERS}, got {prover!r}")
    return prover
