"""Every module of the JAX package has its port.

Walks ``corda_tpu/**/*.py`` and asserts that each file has a counterpart
at the same relative path under ``corda_tpu_torch/``, so a module added to
the JAX package cannot go unported silently. The one exemption is the map
below: the device code, which the port keeps under its own names (plain
PyTorch versions beside the hand-written CUDA kernels they are held to).
The sources of the native cores and the analyzer's baseline are checked
the same way.
"""

from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "corda_tpu"
PORT = REPO / "corda_tpu_torch"

# JAX package module -> the port's files that take its place.
RENAMED = {
    # The verify graph and its host packing: the plain version and the
    # wrappers in ops/ed25519.py; the Pallas kernel's Hopper counterpart.
    "ops/ed25519_jax.py": ("ops/ed25519.py",),
    "ops/ed25519_pallas.py": ("ops/csrc/ed25519_verify.cu",
                              "ops/kernels.py"),
    # SHA-512(R || A || M) mod L: the plain version and its kernel.
    "ops/sha512_jax.py": ("ops/sha512.py", "ops/csrc/sha512_challenge.cu"),
    # SHA-256 of many messages and the Merkle reduce: the plain versions
    # and the two kernels of one source.
    "ops/sha256_jax.py": ("ops/sha256.py", "ops/csrc/sha256.cu"),
}

# Non-Python sources the port keeps its own copies of.
DATA_FILES = ("native/_cverify.c", "native/_ccodec.c", "native/_ccommit.c",
              "analysis/baseline.json")


def _reference_modules():
    return sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_the_walk_sees_the_reference_tree():
    mods = _reference_modules()
    assert len(mods) > 100
    assert set(RENAMED) <= set(mods)


@pytest.mark.parametrize("rel", _reference_modules())
def test_module_has_its_port(rel):
    targets = RENAMED.get(rel, (rel,))
    missing = [t for t in targets if not (PORT / t).is_file()]
    assert not missing, f"corda_tpu/{rel} has no port: {missing}"


@pytest.mark.parametrize("rel", sorted(RENAMED))
def test_renamed_modules_have_no_same_path_copy(rel):
    # The map is the only exemption: a renamed module is not also copied
    # under its JAX name.
    assert not (PORT / rel).exists()


@pytest.mark.parametrize("rel", DATA_FILES)
def test_data_file_has_its_port(rel):
    assert (REF / rel).is_file()
    assert (PORT / rel).is_file()
