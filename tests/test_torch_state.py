"""State carried from the JAX reference into the port.

A JAX plan ingests the first half of a series; its PartialState leaves cross
as numpy arrays (``state_from_numpy``); the port ingests the second half and
finalizes.  The result equals the JAX result over the whole series.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro_torch.core import plan as tplan
from repro_torch.core.streaming import state_from_numpy, state_to_numpy

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

D = 2
FIELDS = ("stat", "sample_sum", "head", "tail", "length", "t0", "stat_err")


def _requests(m):
    return [m.autocovariance_request(4), m.yule_walker_request(2), m.moments_request(6),
            m.moments_request(24), m.welch_request(nperseg=16, overlap=8)]


def _jax_state_to_numpy(state) -> dict:
    return {f: jax.tree.map(np.asarray, getattr(state, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def carried():
    x = np.random.default_rng(4).standard_normal((1000, D)).astype(np.float32)
    jp = jplan.StatPlan(_requests(jplan), d=D, backend="jnp")
    from_chunk = jax.jit(jp.from_chunk)
    whole = jax.jit(lambda s: jp.finalize(s, cache=False))(from_chunk(jnp.asarray(x)))
    (half,) = from_chunk(jnp.asarray(x[:600]))
    return x, whole, _jax_state_to_numpy(half)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_jax_state_finalizes_to_the_jax_result(carried, backend):
    x, whole, half = carried
    tp = tplan.StatPlan(_requests(tplan), d=D, backend=backend, device="cpu")
    states = tp.update((state_from_numpy(half, device="cpu"),), torch.from_numpy(x[600:]))
    got = tp.finalize(states)
    assert int(states[0].length) == 1000 and int(states[0].t0) == 0
    for name, want in whole.items():
        got_leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got[name]))
        for g, w in zip(got_leaves, jax.tree.leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def test_numpy_round_trip(carried):
    _, _, half = carried
    state = state_from_numpy(half, device="cpu")
    back = state_to_numpy(state)
    for f in FIELDS:
        for a, b in zip(jax.tree.leaves(back[f]), jax.tree.leaves(half[f])):
            np.testing.assert_array_equal(a, b)
