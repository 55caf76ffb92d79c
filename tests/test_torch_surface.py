"""The census of the port: every public module-level name and every public
method of the JAX package (go_curdleproofs_tpu) is in the port
(go_curdleproofs_tpu_torch) under the same module path, or stands in
NOT_PORTED with the reason it was left behind. Both packages are parsed
with `ast`; neither is imported."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "go_curdleproofs_tpu"
PORT_PKG = ROOT / "go_curdleproofs_tpu_torch"


def _left(reason, module, *names):
    return {f"{module}:{name}": reason for name in names}


_TUNNEL = "TPU-tunnel machinery: compiled-executable caches and kernel tiers"
_LIMB = ("limb representation (8-bit lazy limbs with interval tags, fetch "
         "canonicalisation); the port's element is canonical 32-bit "
         "Montgomery words")
_RNS = "RNS representation (74 channels, MXU matmuls): TPU arithmetic"

# "module" leaves a whole module behind; "module:name" one name of it
NOT_PORTED = {
    "ops/exe_cache.py": _TUNNEL + " (a persistent cache of XLA executables)",
    "ops/field_backend.py": "chooses between the limb and RNS "
                            "representations; the port has one field form",
    "ops/fp_rns.py": _RNS,
    "ops/rns.py": _RNS,
    "ops/limb_field.py": _LIMB,
    "ops/rns_kernels.py": "the Pallas kernels B1-B7 and their RNS helpers; "
                          "their CUDA counterparts are ops/kernels.py's "
                          "wrappers of the same names",
    "ops/limb_kernels.py": "the Pallas Fr ladder B8; its CUDA counterpart "
                           "is ops/kernels.py's fr_pow_fixed",
    **_left(_TUNNEL, "ops/curve.py", "kernel_scope", "build_table_device"),
    "ops/curve.py:pmap_coords": "renamed: the port's curve.pmap",
    **_left(_LIMB, "ops/fp.py", "FOLD", "RED", "NLIMBS", "Fp", "field",
            "carry_to", "canonical_digits", "prepare_fetch",
            "ints_from_fetched"),
    **_left(_LIMB, "ops/fr.py", "NLIMBS", "Fr", "field", "carry_to",
            "canonical_digits"),
    **_left("one value at a time; the port converts batches (from_ints, "
            "to_ints)", "ops/fp.py", "from_int", "to_int"),
    **_left("one value at a time; the port converts batches (from_ints, "
            "to_ints)", "ops/fr.py", "from_int", "to_int"),
    "ops/fp.py:pow_fixed": "renamed: ops/kernels.py's pow_fixed (B7), "
                           "behind fp.inv and fp.sqrt_candidate",
    "ops/fr.py:pow_fixed": "renamed: ops/kernels.py's fr_pow_fixed (B8), "
                           "behind fr.inv",
    "ops/fr.py:square": "fr.mul(a, a): the Fr product has no square of "
                        "its own",
    "ops/fr.py:mul_small": "fr.mul with fr.from_ints([c]): no caller "
                           "multiplies by a small constant",
    "ops/fr.py:zeros": "fr.from_ints([0] * n): no caller needs a zero "
                       "tensor of its own",
    **_left("TPU window padding (Mosaic sublanes) and the byte constants "
            "of the limb Barrett split; ops/glv_dev.py has its own MU on "
            "16-bit half-limbs",
            "ops/glv.py", "KERNEL_WINDOWS", "LAMBDA_BYTES", "MU", "MU_BYTES"),
    **_left("a jax.sharding mesh and its shard_map executable; the port's "
            "parallel/msm.py shards over a torch.distributed group "
            "(sharded_msm, init_file_group)", "parallel/msm.py", "AXIS",
            "make_mesh", "make_sharded_msm"),
    "models/device_common.py:broadcast_scalar": "torch broadcasting "
                                                "(expand) does it in place",
    "models/device_mode.py:device_prover_version": "the port's prover is an "
        "argument (check_prover), never read from CURDLE_DEVICE_PROVER",
    **_left("the port runs these rounds only inside the one-fetch chain "
            "(device_prover_full); no caller proves one folding argument "
            "alone on the device", "models/device_prover2.py",
            "prove_ipa_on_device", "prove_samemsm_on_device"),
    "utils/profiling.py:ENABLED": "profiling.recording(): CURDLE_PROFILE "
                                  "is read once at import (enable()), and "
                                  "torch.profiler turns spans on",
    "utils/profiling.py:jax_trace": "torch.profiler's own trace; the spans "
                                    "map onto its clock (profiler_us)",
}


def _public(pkg: Path):
    """{module path: set of public names}: module-level functions, classes
    and assigned names, and `Class.method` for the methods of a public
    class."""
    out = {}
    for path in sorted(pkg.rglob("*.py")):
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                if node.name.startswith("_"):
                    continue
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names.update(
                        f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_"))
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names.update(n.id for t in targets for n in ast.walk(t)
                             if isinstance(n, ast.Name)
                             and not n.id.startswith("_"))
        out[str(path.relative_to(pkg))] = names
    return out


JAX = _public(JAX_PKG)
PORT = _public(PORT_PKG)


@pytest.mark.parametrize("module", sorted(JAX))
def test_every_public_name_is_ported_or_left_with_a_reason(module):
    if module in NOT_PORTED:
        assert module not in PORT, (
            f"{module} is in the port: list what is left of it by name")
        return
    missing = sorted(name for name in JAX[module] - PORT.get(module, set())
                     if f"{module}:{name}" not in NOT_PORTED)
    assert not missing, f"{module}: neither ported nor left with a reason: " \
                        f"{missing}"


def test_every_entry_left_behind_is_real_and_not_ported():
    for key, reason in NOT_PORTED.items():
        assert reason and "\n" not in reason, key
        module, _, name = key.partition(":")
        assert module in JAX, f"{key}: no such module in the JAX package"
        if name:
            assert name in JAX[module], f"{key}: no such name"
            assert name not in PORT.get(module, set()), \
                f"{key} is ported: take it off the list"


def test_census_counts_the_newest_names():
    """The folding, device-MSM, functional STROBE and span names are
    counted as ported."""
    assert {"DeviceVec", "DeviceVec.fold", "DeviceVec.msm", "fold_device",
            "StackedVec.fold", "msm_device", "msm_windows_device",
            "msm_stacked_device", "msm_rows_windows_device",
            "msm_rows_device", "to_affine_host_single"} <= PORT["ops/curve.py"]
    assert {"SState", "from_host", "to_host", "absorb", "squeeze", "meta_ad",
            "ad", "prf", "append_message", "challenge_bytes",
            "get_and_append_challenge"} <= PORT["ops/strobe_dev.py"]
    assert {"span", "traced", "count", "records", "drain", "report",
            "reset", "enable", "disable", "profiler_us"} \
        <= PORT["utils/profiling.py"]
