"""The port's plain GF(2^255-19) arithmetic against the JAX package's.

Seeded numpy limbs go through corda_tpu.ops.fe25519 and
corda_tpu_torch.ops.fe25519; every operation must give IDENTICAL limbs
(the port mirrors the JAX module op for op), and the values must match
Python-int arithmetic mod p. All comparisons are exact: integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corda_tpu.ops import fe25519 as jfe
from corda_tpu_torch.ops import fe25519 as tfe

P = tfe.P
N = 16


def _lazy_limbs(seed):
    """(20, N) int32 limbs inside the lazy contract: canonical 13-bit limbs
    for half the lanes, signed |limb| <= 9000 for the rest; lane 0 = p - 1
    and lane 1 = 2^260 - 1 as edge values."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 13, (20, N)).astype(np.int32)
    limbs[:, N // 2:] = rng.integers(-9000, 9001, (20, N - N // 2))
    limbs[:, 0] = jfe.limbs_of_int(P - 1)
    limbs[:, 1] = jfe.limbs_of_int((1 << 260) - 1)
    return limbs


def _ints(limbs):
    arr = np.asarray(limbs)
    return [sum(int(arr[i, j]) << (13 * i) for i in range(arr.shape[0]))
            for j in range(arr.shape[1])]


A = _lazy_limbs(1)
B = _lazy_limbs(2)

OPS = [
    ("mul", lambda m, a, b: m.mul(a, b), lambda x, y: x * y),
    ("sq", lambda m, a, b: m.sq(a), lambda x, y: x * x),
    ("add", lambda m, a, b: m.add(a, b), lambda x, y: x + y),
    ("sub", lambda m, a, b: m.sub(a, b), lambda x, y: x - y),
    ("neg", lambda m, a, b: m.neg(a), lambda x, y: -x),
    ("mul_small_2", lambda m, a, b: m.mul_small(a, 2), lambda x, y: 2 * x),
    ("mul_small_16", lambda m, a, b: m.mul_small(a, 16), lambda x, y: 16 * x),
    ("freeze", lambda m, a, b: m.freeze(a), lambda x, y: x),
    ("normalize", lambda m, a, b: m.normalize(a), lambda x, y: x),
    ("inv", lambda m, a, b: m.inv(a), lambda x, y: pow(x, P - 2, P)),
    ("pow_p58", lambda m, a, b: m.pow_p58(a),
     lambda x, y: pow(x, (P - 5) // 8, P)),
]


@pytest.mark.parametrize("name,op,pyop", OPS, ids=[o[0] for o in OPS])
def test_identical_limbs_to_jax_and_values_mod_p(name, op, pyop):
    got = op(tfe, torch.from_numpy(A), torch.from_numpy(B)).numpy()
    want = np.asarray(op(jfe, jnp.asarray(A), jnp.asarray(B)))
    assert got.dtype == np.int32
    assert np.array_equal(got, want), f"{name}: limbs differ from JAX"
    vals = [pyop(x, y) % P for x, y in zip(_ints(A), _ints(B))]
    assert [v % P for v in _ints(got)] == vals
    if name == "freeze":
        assert _ints(got) == vals  # canonical: in [0, p)


def test_eq_select_is_zero_match_jax():
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    ja, jb = jnp.asarray(A), jnp.asarray(B)
    same = tfe.add(a, tfe.fill_limbs(P, (N,)))  # a + p == a (mod p)
    assert bool(tfe.eq(a, same).all())
    assert tfe.eq(a, b).numpy().tolist() == np.asarray(jfe.eq(ja, jb)).tolist()
    mask = torch.arange(N) % 3 == 0
    assert np.array_equal(tfe.select(mask, a, b).numpy(),
                          np.asarray(jfe.select(jnp.asarray(mask.numpy()),
                                                ja, jb)))
    zero = tfe.sub(a, a)
    assert bool(tfe.is_zero(zero).all())


def test_limb_helpers_match_jax():
    for x in (0, 1, P - 1, P, (1 << 260) - 1, 608):
        assert np.array_equal(tfe.limbs_of_int(x), jfe.limbs_of_int(x))
        assert tfe.int_of_limbs(torch.from_numpy(tfe.limbs_of_int(x))) == x
    fill = tfe.fill_limbs(12345, (3,))
    assert np.array_equal(fill.numpy(), np.asarray(jfe.fill_limbs(12345, (3,))))
    with pytest.raises(ValueError):
        tfe.limbs_of_int(1 << 260)
