"""The JAX package's stand-alone device IPA prover
(go_curdleproofs_tpu/models/device_prover2.py, run on the CPU through XLA as
tests/test_device_prover2.py runs it) against the port's, at N=8 with the
same seeds: the proofs are byte-identical and the transcripts end in
lockstep. A call into a JAX device prover compiles every piece with XLA on
the CPU (about two minutes), which is why this one and the same-multiscalar
one (tests/test_torch_device_prover_jax_sm.py) each have a file, and so a
worker, of their own."""

import io

import torch

from go_curdleproofs_tpu.models import device_prover2 as jdp2
from go_curdleproofs_tpu.utils.rand import Rand as JRand
from go_curdleproofs_tpu.utils.transcript import Transcript as JTranscript
from go_curdleproofs_tpu_torch.models import device_prover2
from go_curdleproofs_tpu_torch.utils.rand import Rand
from go_curdleproofs_tpu_torch.utils.transcript import Transcript
from test_torch_device_prover import ipa_instance

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _ser(p) -> bytes:
    b = io.BytesIO()
    p.serialize(b)
    return b.getvalue()


def test_device_ipa_byte_identical_to_jax_device_ipa():
    gs, gsp, h, C, D, z, cs, ds = ipa_instance()
    jt, jr = JTranscript(b"ipa"), JRand(7)
    want = jdp2.prove_ipa_on_device(gs, gsp, h, C, D, z, list(cs), list(ds),
                                    jt, jr)
    t, r = Transcript(b"ipa"), Rand(7)
    got = device_prover2.prove_ipa_on_device(gs, gsp, h, C, D, z, list(cs),
                                             list(ds), t, r, device=CPU)
    assert _ser(got) == _ser(want)
    assert (t.get_and_append_challenge(b"probe")
            == jt.get_and_append_challenge(b"probe"))
    assert r.get_fr() == jr.get_fr()
