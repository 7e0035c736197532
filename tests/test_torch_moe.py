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

"""The port's MoE routing and MoETransformerLM against the JAX package.

Routing: the dense form (``top_k_routing``) on seeded logits with
forced ties and overflowing experts gives the JAX function's
``dispatch`` exactly and its ``combine`` to 1e-6 relative (the softmax's
f32 exp: XLA's and ATen's differ in the last bit), ``aux`` to 1e-6; the
index form (``top_k_routing_indices``, the model's path) rebuilds the
dense form's tensors exactly, and ``dense_moe`` (index form) agrees with
``dense_moe_reference`` (the JAX einsums written out) to the f32 sums'
order, values and gradients. The model: logits and aux against the
flax module in f32 (1e-5 logits, 1e-6 aux) and bf16 (logits within 2e-2
of their largest magnitude, tests/test_torch_transformer.py's rule),
learned/MHA and rope/GQA, with a window, and with int8 weights (the
experts stay native); the converters' round trip and flax's init
scale. Trainer steps, engines, speculation and the launcher are in
tests/test_torch_moe_engine.py and tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models.quantized import (
    convert_params_int8,
)
from container_engine_accelerators_tpu.parallel import dense_moe as jax_moe
from container_engine_accelerators_tpu.parallel.expert import (
    expert_capacity as jax_capacity,
)
from container_engine_accelerators_tpu.parallel.expert import (
    top_k_routing as jax_routing,
)
from container_engine_accelerators_tpu_torch.models import convert, moe
from container_engine_accelerators_tpu_torch.parallel import expert
from tests import torch_parity

T, D, F, E = 64, 16, 32, 4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _gate_logits(seed, t=T, e=E):
    """Seeded logits with forced ties: rows whose experts tie, rows
    equal to an earlier row, and a column that most rows prefer (its
    queue overflows)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    logits[:, 1] += 1.5
    logits[3] = 0.25                        # all experts tie
    logits[7, 2] = logits[7, 1]             # a two-way tie
    logits[11] = logits[5]                  # a repeated token
    return logits


def _weights(seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((T, D)),
              rng.standard_normal((D, E)),
              rng.standard_normal((E, D, F)) * 0.1,
              rng.standard_normal((E, F, D)) * 0.1)
    return [a.astype(np.float32) for a in arrays]


def _dense_from_indices(expert_idx, slot, keep, weight, t, e, cap):
    dispatch = torch.zeros((t, e, cap))
    combine = torch.zeros((t, e, cap))
    rows = torch.arange(t)[:, None].expand_as(expert_idx)
    dispatch[rows[keep], expert_idx[keep], slot[keep]] = 1.0
    combine[rows[keep], expert_idx[keep], slot[keep]] = weight[keep]
    return dispatch, combine


def _flat(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat(tree[key], prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(tree[key])


# -- routing --------------------------------------------------------------


@pytest.mark.parametrize("cap", [3, 9, 64])
@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_matches_jax(top_k, cap):
    """Counterpart of tests/test_expert.py:69: each (expert, slot)
    serves at most one token and the kept mass is at most 1, checked
    through equality with the JAX function; capacity 3 and 9 overflow
    the preferred expert, 64 drops nothing."""
    logits = _gate_logits(top_k * 100 + cap)
    want_d, want_c, want_aux = jax_routing(jnp.asarray(logits), cap,
                                           top_k=top_k)
    got_d, got_c, got_aux = expert.top_k_routing(torch.from_numpy(logits),
                                                 cap, top_k=top_k)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=0,
                               atol=1e-6)
    assert got_d.sum(0).max() <= 1.0
    assert got_d.sum((1, 2)).max() <= top_k
    dropped = got_d.sum() < top_k * T
    assert dropped == (cap < 64)


def test_routing_uniform_aux_is_one():
    """tests/test_expert.py:84: a uniform router's aux is 1."""
    logits = torch.zeros((64, E))
    _, _, aux = expert.top_k_routing(logits, capacity=64, top_k=1)
    *_, aux_idx = expert.top_k_routing_indices(logits, 64, top_k=1)
    _, _, want = jax_routing(jnp.zeros((64, E)), capacity=64, top_k=1)
    assert float(aux) == float(aux_idx) == pytest.approx(1.0, rel=1e-6)
    assert float(aux) == pytest.approx(float(want), abs=1e-6)


@pytest.mark.parametrize("args", [(64, 4, 1.0, 1), (64, 4, 1.25, 2),
                                  (1, 64, 1.0, 1), (16384, 8, 1.25, 2),
                                  (8, 8, 1.25, 2), (1920, 8, 1.25, 2)])
def test_expert_capacity_matches_jax(args):
    """tests/test_expert.py:91, and the serving and training shapes:
    8 slots give 3 a queue, a 1920-wide admission 600, the LM training
    batch 5120."""
    assert expert.expert_capacity(*args) == jax_capacity(*args)
    assert expert.expert_capacity(1, 64, 1.0, 1) == 1
    assert expert.expert_capacity(16384, 8, 1.25, 2) == 5120


@pytest.mark.parametrize("cap", [3, 9, 64])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_index_form_rebuilds_the_dense_form(top_k, cap):
    """The model's index form holds the dense form's slot assignment
    exactly, and its weights bit for bit."""
    logits = torch.from_numpy(_gate_logits(top_k * 10 + cap))
    want_d, want_c, want_aux = expert.top_k_routing(logits, cap, top_k)
    idx, slot, keep, weight, aux = expert.top_k_routing_indices(
        logits, cap, top_k)
    assert idx.shape == slot.shape == keep.shape == (T, top_k)
    got_d, got_c = _dense_from_indices(idx, slot, keep, weight, T, E, cap)
    assert torch.equal(got_d, want_d) and torch.equal(got_c, want_c)
    assert float(aux) == float(want_aux)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("factor", [1.0, 1.25, 4.0])
def test_dense_moe_index_form_matches_reference_and_jax(top_k, factor):
    """``dense_moe`` (indices) against ``dense_moe_reference`` (the
    JAX einsums) in f32: outputs to 1e-6, aux equal, and every input's
    gradient to 1e-5; both against the JAX ``dense_moe`` to 1e-5."""
    arrays = _weights(top_k)
    kwargs = dict(capacity_factor=factor, top_k=top_k)
    outs = {}
    for name, fn in (("index", expert.dense_moe),
                     ("reference", expert.dense_moe_reference)):
        tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
        out, aux = fn(*tensors, **kwargs)
        ((out ** 2).sum() + aux).backward()
        outs[name] = (out.detach(), aux.detach(),
                      [t.grad for t in tensors])
    (o1, a1, g1), (o2, a2, g2) = outs["index"], outs["reference"]
    torch.testing.assert_close(o1, o2, rtol=0, atol=1e-6)
    assert float(a1) == float(a2)
    for got, want in zip(g1, g2):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    want, want_aux = jax_moe(*map(jnp.asarray, arrays), **kwargs)
    np.testing.assert_allclose(o1.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(a1), float(want_aux), atol=1e-6)


def test_dense_moe_bf16_matches_jax():
    """In bf16 (tokens and expert weights; the gate f32) the index
    form equals the reference bit for bit and the JAX function within
    one bf16 rounding of the output."""
    arrays = _weights(7)
    dt = [torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16]
    tensors = [torch.from_numpy(a).to(d) for a, d in zip(arrays, dt)]
    got, aux = expert.dense_moe(*tensors)
    ref, ref_aux = expert.dense_moe_reference(*tensors)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref) and float(aux) == float(ref_aux)
    jdt = [jnp.bfloat16, jnp.float32, jnp.bfloat16, jnp.bfloat16]
    want, want_aux = jax_moe(*(jnp.asarray(a).astype(d)
                               for a, d in zip(arrays, jdt)))
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)


def test_expert_parallel_is_not_ported():
    """Expert parallelism is ported now (tests/test_torch_expert.py
    holds it against the JAX function on gloo ranks): its mesh needs a
    process group, as every mesh of the port does, and the layer on an
    expert axis one rank wide is dense_moe."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import (
        distributed,
    )

    with pytest.raises(RuntimeError, match="process group"):
        expert.build_expert_mesh(2)
    assert expert.EXPERT_AXIS == "expert"
    rng = np.random.default_rng(0)
    tensors = [torch.from_numpy(a) for a in (
        rng.standard_normal((16, 8)).astype(np.float32),
        rng.standard_normal((8, 4)).astype(np.float32),
        rng.standard_normal((4, 8, 16)).astype(np.float32) * 0.1,
        rng.standard_normal((4, 16, 8)).astype(np.float32) * 0.1)]
    distributed.start_local_group("cpu")
    try:
        mesh = expert.build_expert_mesh(1)
        got, aux = expert.expert_parallel_moe(mesh, *tensors)
    finally:
        dist.destroy_process_group()
    want, want_aux = expert.dense_moe(*tensors)
    assert torch.equal(got, want) and float(aux) == float(want_aux)


# -- the model ------------------------------------------------------------

LOGIT_TOL = {"f32": 1e-5, "bf16": 2e-2}


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if dtype == "bf16" else 1.0
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=LOGIT_TOL[dtype],
                               atol=LOGIT_TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", sorted(LOGIT_TOL))
@pytest.mark.parametrize("variant", sorted(torch_parity.VARIANTS))
def test_forward_matches_flax(variant, dtype):
    """Logits and aux of one forward of 2 x 12 tokens (T 24, 4
    experts, capacity 15: a dropping group)."""
    model, tree, config = torch_parity.flax_moe(variant, dtype)
    toks = torch_parity.tokens(0, (2, 12))
    want, want_aux = jax.jit(model.apply)({"params": tree},
                                          jnp.asarray(toks))
    port = torch_parity.port_lm(config, tree, dtype)
    assert isinstance(port, moe.MoETransformerLM)
    got, aux = port(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 12, 64)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    _close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=1e-6 if dtype == "f32" else 1e-3)


@pytest.mark.parametrize("dtype", sorted(LOGIT_TOL))
def test_windowed_forward_matches_flax(dtype):
    model, tree, config = torch_parity.flax_moe("rope_gqa", dtype,
                                                attention_window=5)
    toks = torch_parity.tokens(1, (2, 16))
    want, want_aux = jax.jit(model.apply)({"params": tree},
                                          jnp.asarray(toks))
    got, aux = torch_parity.port_lm(config, tree, dtype)(
        torch.from_numpy(toks).long())
    _close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=1e-6 if dtype == "f32" else 1e-3)


def test_routed_layers_alternate_and_aux_averages():
    """Odd layers are routed; aux is the mean of theirs, 0 without
    one (a 1-layer model)."""
    _, tree, config = torch_parity.flax_moe("learned_mha",
                                            num_layers=4)
    port = torch_parity.port_lm(config, tree)
    kinds = [type(b).__name__ for b in port.blocks]
    assert kinds == ["Block", "MoEBlock", "Block", "MoEBlock"]
    seen = []
    for block in port.blocks[1::2]:
        block.moe.register_forward_hook(
            lambda _m, _i, out: seen.append(float(out[1])))
    _, aux = port(torch.from_numpy(torch_parity.tokens(2, (1, 9))).long())
    assert float(aux) == pytest.approx(sum(seen) / 2, abs=1e-7)
    one, tree1, config1 = torch_parity.flax_moe("learned_mha",
                                                num_layers=1)
    _, aux1 = torch_parity.port_lm(config1, tree1)(torch.zeros(
        (1, 4), dtype=torch.long))
    assert float(aux1) == 0.0 and aux1.dtype == torch.float32


def test_int8_weights_leave_the_experts_native():
    """``quantize_lm`` converts the attention and dense-MLP kernels and
    copies the expert leaves; the int8 model's forward matches the
    flax int8 clone on the JAX package's own converted tree."""
    model, tree, config = torch_parity.flax_moe("rope_gqa")
    q_model = model.clone(weights="int8")
    template = jax.tree_util.tree_map(np.asarray, q_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    want_tree = convert_params_int8(template, tree)
    got_tree = convert.quantize_lm(config, tree)
    for leaf in ("gate", "w_in", "w_out"):
        assert got_tree["block1"]["moe"][leaf] is tree["block1"]["moe"][leaf]
    assert "kernel_q" in got_tree["block1"]["attn"]["q"]
    assert "kernel_q" in got_tree["block0"]["Dense_0"]
    flat_want = dict(_flat(want_tree))
    flat_got = dict(_flat(got_tree))
    assert set(flat_got) == set(flat_want)
    for name, value in flat_want.items():
        np.testing.assert_array_equal(flat_got[name], value, err_msg=name)
    toks = torch_parity.tokens(3, (2, 10))
    want, _ = jax.jit(q_model.apply)({"params": want_tree},
                                     jnp.asarray(toks))
    port = convert.load_lm(dict(config, weights="int8"), got_tree,
                           device="cpu", dtype=torch.float32)
    assert port.blocks[1].moe.w_in.dtype == torch.float32
    got, _ = port(torch.from_numpy(toks).long())
    _close(got, want, "f32")


@pytest.mark.parametrize("variant", sorted(torch_parity.VARIANTS))
def test_converters_round_trip_and_flax_shapes(variant):
    """``flax_shapes`` names every leaf of the flax MoE tree with its
    shape; ``params_to_flax`` inverts ``params_from_flax`` bit for bit;
    the serving model holds the gate in f32 and the experts in the
    compute dtype."""
    _, tree, config = torch_parity.flax_moe(variant)
    flat = dict(_flat(tree))
    shapes = {"/".join(path): shape
              for path, shape in convert.flax_shapes(config).values()}
    assert shapes == {name: value.shape for name, value in flat.items()}
    port = convert.load_lm(config, tree, device="cpu",
                           dtype=torch.float32)
    back = dict(_flat(convert.params_to_flax(port, config)))
    for name, value in flat.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    serving = convert.load_lm(config, tree, device="cpu")
    assert serving.blocks[1].moe.gate.dtype == torch.float32
    assert serving.blocks[1].moe.w_in.dtype == torch.bfloat16
    assert not serving.training


def test_init_follows_flax_lecun_normal_on_stacked_kernels():
    """flax counts the expert axis into a stacked kernel's fan-in: the
    numpy init draws the gate at std 1/sqrt(d), w_in at 1/sqrt(E d) and
    w_out at 1/sqrt(E f), each cut at two standard deviations; the
    flax init's own leaves have the same spread."""
    _, flax_tree, config = torch_parity.flax_moe("learned_mha",
                                                 embed_dim=128,
                                                 num_experts=8)
    tree = convert.init_flax_layout_params(config, 0)
    d, f, e = 128, 512, 8
    for leaf, fan_in, rel in (("gate", d, 0.1), ("w_in", e * d, 0.02),
                              ("w_out", e * f, 0.02)):
        value = tree["block1"]["moe"][leaf]
        std = fan_in ** -0.5
        assert value.dtype == np.float32
        assert np.abs(value).max() <= 2 * std / 0.87962566 + 1e-6
        assert value.std() == pytest.approx(std, rel=rel), leaf
        assert flax_tree["block1"]["moe"][leaf].std() == pytest.approx(
            std, rel=rel), leaf
    assert "moe" not in tree["block0"] and "Dense_0" in tree["block0"]
