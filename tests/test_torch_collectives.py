# Copyright 2026 The container-engine-accelerators-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""The port's explicit collectives (parallel/collectives.py) on four
gloo ranks against the JAX package's on a four-device CPU submesh:
the seven cases of tests/test_collectives.py, on the same numpy
inputs. Each rank holds its leading-dim shard of the JAX global array
(the whole array for reduce_scatter); the ranks' results, stacked in
rank order, must equal the JAX result's shards. Sums of f32 values in
another order: rtol/atol 1e-5, as the JAX test holds the ring to
psum; the rest is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from container_engine_accelerators_tpu.parallel import build_mesh
from container_engine_accelerators_tpu.parallel.collectives import (
    all_gather as jax_all_gather,
    all_reduce_mean as jax_all_reduce_mean,
    reduce_scatter as jax_reduce_scatter,
    ring_all_reduce as jax_ring_all_reduce,
)
from container_engine_accelerators_tpu.parallel.distributed import (
    initialize_from_plugin_env as jax_initialize,
)
from container_engine_accelerators_tpu.parallel.mesh import MeshSpec
from container_engine_accelerators_tpu_torch.parallel import distributed
from tests import torch_dist_cases as cases
from tests.torch_dist_pool import RankPool

N = 4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jax_mesh():
    return build_mesh(MeshSpec(data=N), devices=jax.devices()[:N])


def _shards(x, n=N):
    return np.asarray(x).reshape((n, -1) + np.asarray(x).shape[1:])


def _stacked(results):
    return np.concatenate([np.asarray(r) for r in results])


def test_all_reduce_mean(pool, jax_mesh):
    x = np.arange(16.0, dtype=np.float32).reshape(16, 1)
    want = np.asarray(jax_all_reduce_mean(jax_mesh, jnp.asarray(x)))
    got = pool.run(cases.collective, "all_reduce_mean", x)
    np.testing.assert_array_equal(_stacked(got), want)
    expect = np.mean(np.arange(16.0).reshape(N, 4), axis=0)
    np.testing.assert_allclose(got[0].reshape(-1), expect)


def test_all_gather(pool, jax_mesh):
    x = np.arange(8.0, dtype=np.float32)
    want = np.asarray(jax_all_gather(jax_mesh, jnp.asarray(x)))
    got = pool.run(cases.collective, "all_gather", x)
    for rank_out in got:
        np.testing.assert_array_equal(rank_out, want)
        np.testing.assert_array_equal(rank_out, np.arange(8.0))


def test_reduce_scatter(pool, jax_mesh):
    x = np.ones((8, 4), np.float32)
    want = np.asarray(jax_reduce_scatter(jax_mesh, jnp.asarray(x)))
    got = pool.run(cases.collective, "reduce_scatter", x)
    assert [r.shape for r in got] == [(2, 4)] * N
    np.testing.assert_array_equal(_stacked(got), want)
    np.testing.assert_array_equal(_stacked(got), np.full((8, 4), 4.0))


def test_ring_all_reduce_matches_psum(pool, jax_mesh):
    x = np.random.default_rng(0).standard_normal((64, 16)).astype(
        np.float32)
    want = np.asarray(jax_ring_all_reduce(jax_mesh, jnp.asarray(x)))
    psum = np.asarray(jax_all_reduce_mean(jax_mesh, jnp.asarray(x))) * N
    got = _stacked(pool.run(cases.collective, "ring_all_reduce", x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, psum, rtol=1e-5, atol=1e-5)


def test_ring_all_reduce_single_device(pool):
    """A one-rank data mesh: the ring is the identity, as the JAX
    function's n == 1 branch (ranks outside the mesh take no part)."""
    x = np.ones((4, 4), np.float32)
    jax_one = build_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    want = np.asarray(jax_ring_all_reduce(jax_one, jnp.asarray(x)))
    got = pool.run(cases.collective, "ring_all_reduce", x, data=1)
    np.testing.assert_array_equal(got[0], want)
    assert got[1:] == [None] * (N - 1)


def test_initialize_single_host_is_noop(monkeypatch):
    calls = []

    def never(**kwargs):
        calls.append(kwargs)

    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "localhost")
    assert distributed.initialize_from_plugin_env(_initialize=never) is False
    assert jax_initialize(_initialize=never) is False
    monkeypatch.delenv("TPU_WORKER_HOSTNAMES")
    assert distributed.initialize_from_plugin_env(_initialize=never) is False
    assert jax_initialize(_initialize=never) is False
    assert calls == []


def test_ring_all_reduce_non_divisible_shard(pool, jax_mesh):
    """Each rank's shard of 2 x 3 = 6 values does not divide into 4
    blocks: the zero-padded schedule still gives the sum."""
    x = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    want = np.asarray(jax_ring_all_reduce(jax_mesh, jnp.asarray(x)))
    psum = np.asarray(jax_all_reduce_mean(jax_mesh, jnp.asarray(x))) * N
    got = _stacked(pool.run(cases.collective, "ring_all_reduce", x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, psum, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:2], _shards(x).sum(0), rtol=1e-5,
                               atol=1e-5)
