"""Deferred verification (the JAX package's models/curdleproof.py: verify
with accumulator=) on the port, on the CPU: proofs fold their checks into
one caller-owned MsmAccumulator, and the caller runs the one final MSM.

The ELL=4 proof is tests/test_torch_prover.py's fixture, built again here
so that `--dist loadfile` can run this file beside that one. Verdicts are
compared with the JAX package's: exact, no tolerance."""

import io

import torch

from go_curdleproofs_tpu.models import curdleproof as jcurdleproof
from go_curdleproofs_tpu.models.msm_accumulator import \
    MsmAccumulator as JMsmAccumulator
from go_curdleproofs_tpu.utils.rand import Rand as JRand
from go_curdleproofs_tpu_torch import convert
from go_curdleproofs_tpu_torch.models import curdleproof
from go_curdleproofs_tpu_torch.models.msm_accumulator import MsmAccumulator
from go_curdleproofs_tpu_torch.ops import curve
from go_curdleproofs_tpu_torch.utils.rand import Rand
from test_torch_prover import CPU, _proof_bytes, _tamper, _verify
from test_torch_prover import fresh  # noqa: F401 (the ELL=4 proof fixture)

torch.set_num_threads(1)


def test_deferred_verify_into_one_accumulator(fresh, monkeypatch):
    """Two proofs, one valid and one of a tampered instance, fold into one
    caller-owned accumulator: each verify returns before any MSM, the
    caller runs the one final MSM, and every verdict is the JAX package's.
    Without accumulator= each verify runs its own MSM, as before."""
    msms = []
    for name in ("msm", "msm_with_static"):
        real = getattr(curve, name)
        monkeypatch.setattr(curve, name, lambda *a, _f=real, **k:
                            msms.append(1) or _f(*a, **k))
    bad = {**fresh, **_tamper(fresh, "tampered_m")}
    acc = MsmAccumulator(device=CPU, static_bases=curdleproof._gh_static(
        fresh["crs"], CPU))
    got = [curdleproof.verify(f["proof"], f["crs"], f["Rs"], f["Ss"],
                              f["Ts"], f["Us"], f["M"], Rand(i), device=CPU,
                              accumulator=acc)
           for i, f in enumerate((fresh, bad))]
    assert msms == []
    got.append(acc.verify())
    assert msms == [1]
    jproof = jcurdleproof.Proof.from_reader(
        io.BytesIO(_proof_bytes(fresh["proof"])))
    jcrs = jcurdleproof.CRS(**convert.crs_to_affine(fresh["crs"]))
    jacc = JMsmAccumulator()
    want = [jcurdleproof.verify(jproof, jcrs, f["Rs"], f["Ss"], f["Ts"],
                                f["Us"], f["M"], JRand(i), accumulator=jacc)
            for i, f in enumerate((fresh, bad))]
    want.append(jacc.verify())
    assert got == want == [True, True, False]
    # the default path: one MSM a verify
    assert _verify(fresh) and not _verify(bad)
    assert msms == [1] * 3
