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

"""The multichip dryrun's stage 2 on the (2, 2, 2) ("data", "context",
"expert") mesh, on eight gloo ranks against the JAX stage on the 8
CPU devices: every axis wider than one at once. The step (loss to rtol
1e-5, parameters by tests/test_torch_dryrun.py's Adam rule), and the
gradients before the update (rtol 1e-4 / atol 1e-6), the clip's
global norm and the reported loss against jax.grad's, with the
Trainer's gradient reduction counted: one flat all-reduce over the
context group and one over the data group, each carrying every local
gradient, the expert-sharded kernels included (summed over "context",
averaged over "data" exactly once, never reduced over "expert")."""

import numpy as np
import pytest

from tests import torch_dist_cases as cases
from tests.test_torch_dryrun import (
    LOSS_RTOL,
    assert_adam_step_close,
    assert_trees_close,
    jax_stage2,
    jax_stage2_grads,
)
from tests.torch_dist_pool import RankPool

N = 8
SHAPE = (2, 2, 2)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


@pytest.fixture(scope="module")
def stage2():
    init, tokens, loss, params = jax_stage2(*SHAPE)
    return init, tokens, loss, params, jax_stage2_grads(*SHAPE, init,
                                                        tokens)


def test_stage2_on_2x2x2_matches_the_jax_dryrun(pool, stage2):
    """One Adam step of the MoE LM on (2, 2, 2): the routed layers'
    groups are ("data", "context") runs of 32 tokens, each routed in
    two expert subgroups; every rank holds two experts of four."""
    init, tokens, want_loss, want, (_, grads, _) = stage2
    got = pool.run(cases.dryrun_stage, "dp_sp_ep", params=init,
                   batch=tokens, shape=SHAPE)
    for r in got:
        assert r["step"] == 1 and r["local_experts"] == 2
        assert r["mesh"] == {"data": 2, "context": 2, "expert": 2}
        np.testing.assert_allclose(r["loss"], want_loss, rtol=LOSS_RTOL)
    for r in (got[0], got[7]):
        assert_adam_step_close(r["params"], want, init, grads)


def test_stage2_gradients_on_2x2x2_reduce_once(pool, stage2):
    """The gradients of one step before the update, whole on every rank,
    the clip's norm and the reported loss against jax.grad's; the
    reduction's all-reduces as (group, elements): the context group,
    then the data group, each once with every local gradient."""
    init, tokens, _, _, (want_loss, want, want_norm) = stage2
    got = pool.run(cases.combined_grads, init, tokens, SHAPE)
    for rank, r in enumerate(got):
        np.testing.assert_allclose(r["loss"], want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["norm"], want_norm, rtol=1e-5)
        assert_trees_close(r["grads"], want)
        d, e = rank // 4, rank % 2
        context = [d * 4 + e, d * 4 + 2 + e]
        data = [rank % 4, rank % 4 + 4]
        assert r["all_reduces"] == [(context, r["local_numel"]),
                                    (data, r["local_numel"])], rank
