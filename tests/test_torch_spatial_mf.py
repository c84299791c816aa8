"""Spatial sharding of the MedFormer configurations that shard beside the
default one, on the CPU, against the JAX package's spatial step, with the
helpers and bounds of ``tests/test_torch_spatial_zoo.py`` (a file of its
own so that the two JAX compiles of the largest graphs run beside the
zoo's): ``mf_mbconv`` at ``TINY``'s widths (MBConv stages, channels-last
on the depthwise kernel's plain version, sharded beside attention, linear
projections, GELU) and attention in ``UpBlockMF_2`` (that stage gathered,
run whole and sharded again; the channel-first stages on halo slabs), each
the ``dice`` step at 64×32×32 × 1 on a 1 × 2 grid of gloo ranks (job
``mf`` of ``tests/test_torch_spatial_zoo_ranks.py``). Gradients at
BALL_GRAD_TOL raised by the ρ rule, loss terms at 1e-4·|ref|.
"""

import pytest

from test_torch_spatial_zoo import (cases, check_bits, check_places,
                                    check_step, launch)

JOBS_HERE = ("mf",)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return launch(tmp_path_factory, JOBS_HERE)


def test_ranks_sit_on_the_jax_meshs_grid(run):
    check_places(run, "mf")


@pytest.mark.parametrize("job,case", cases(JOBS_HERE))
def test_sharded_step_matches_jax_spatial_step(run, job, case):
    check_step(run, job, case)


@pytest.mark.parametrize("job,case", cases(JOBS_HERE))
def test_every_rank_holds_the_same_bits(run, job, case):
    check_bits(run, job, case)
