"""The port's samplers with their chains split over a mesh, in a 4-rank
gloo world on the CPU (``torch_parallel_worlds.mcmc_world``): HMC, NUTS,
parallel tempering on a small WHVI g posterior, and HMC with the dense
metric on a correlated Gaussian, each 4 chains over the (1, 4) and (2, 2)
meshes, against the unsharded run on the same generator seed (every rank
draws the whole run's numbers and keeps its chains'). Tolerance 1e-5: one
chain a rank takes the same ops as four in one batch, up to the batch's
summation order. Also ``n_chains`` not a multiple of the world, refused
as ``whvi_tpu/mcmc/chains.py:175-180`` refuses it."""

import numpy as np
import pytest
import torch

import torch_parallel_worlds as w
from whvi_tpu_torch.mcmc.chains import _leaves
from whvi_tpu_torch.parallel.distributed import spawn

torch.set_num_threads(1)

CHAIN_TOL = 1e-5


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.fixture(scope="module")
def world():
    return spawn(w.mcmc_world, w.WORLD, "gloo", "cpu")


@pytest.fixture(scope="module")
def unsharded():
    return {name: w.sampler_run(name) for name in w.SAMPLERS}


@pytest.mark.parametrize("name", list(w.SAMPLERS))
@pytest.mark.parametrize("layout", [(1, 4), (2, 2)])
def test_sharded_chains_match_unsharded(world, unsharded, layout, name):
    samples, stats = world[0][(layout, name)]
    want_samples, want_stats = unsharded[name]
    for got, want in zip(_leaves(samples), _leaves(want_samples)):
        assert got.shape[0] == w.WORLD
        assert rel_err(got, want) <= CHAIN_TOL
    assert sorted(stats) == sorted(want_stats)
    for k in want_stats:
        assert stats[k].dtype == want_stats[k].dtype, k
        assert rel_err(stats[k], want_stats[k]) <= CHAIN_TOL, k
    # every rank returns every chain
    for r in world[1:]:
        for a, b in zip(_leaves(r[(layout, name)][0]), _leaves(samples)):
            assert torch.equal(a, b)


def test_n_chains_not_a_multiple_of_the_world(world):
    message = world[0]["refusals"]["n_chains"]
    assert message is not None and "n_chains=6 must be a multiple of the mesh device count 4" in message
