"""The port's data-parallel train step against the JAX package's, on the CPU.

A small ResNet (``stage_sizes`` [1, 1, 1, 1], 32x32, 10 classes) built in
both packages with the same weights (``models/convert.cnn_params_to_flax``);
the same batches from a numpy seed; the masked mean cross-entropy of the
JAX estimator. Both packages train the WHOLE variable tree, BatchNorm
statistics included (flax's ``batch_stats`` are params to
``jax.value_and_grad``), so the statistics are held too.

One process against a one-device JAX mesh: every shard is the whole batch,
so padded rows and padded microbatches weigh the same on both sides.
Tolerances: SGD element by element at atol 1e-5 (summation order only);
Adam turns a near-zero gradient into a step of about ±lr, so its runs are
held on the elements whose first gradient is not near zero, and on the
loss history at rtol 1e-3 (the elements with gradients near 1e-8, whose
summation-order error is a large share of themselves, move the loss by
up to 1e-4 relative in three steps at lr 1e-3); bf16 compute rounds the
weights the forward sees, and the JAX package also computes BatchNorm's
``rsqrt(var + eps) * scale`` in bf16 where the port computes it in f32
from the rounded values, so 2e-3.

The weights are drawn by the port (``init_cnn_params``) and carried to
flax with ``cnn_params_to_flax``: flax's own init would compile for
longer than the tests run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from sparkdl_tpu.graph.ingest import ModelIngest
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu.parallel import create_train_state as jax_create_train_state
from sparkdl_tpu.parallel import make_data_parallel_step as jax_make_step
from sparkdl_tpu.parallel import make_mesh as jax_make_mesh
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models.convert import cnn_params_to_flax
from sparkdl_tpu_torch.models.layers import init_cnn_params
from sparkdl_tpu_torch.models.resnet import ResNet
from sparkdl_tpu_torch.parallel import create_train_state, make_data_parallel_step, make_mesh

SGD_ATOL = 1e-5
ADAM_LOSS_RTOL = 1e-3
#: elements whose first gradient is at least this are held at ADAM_ATOL
ADAM_GRAD_FLOOR = 1e-4
ADAM_ATOL = 1e-5
BF16_ATOL = 2e-3
ROWS = 16
LR = 0.01


@pytest.fixture(scope="module")
def models():
    """(JAX ModelFunction, its variables, a port ModelFunction with the
    same weights on the CPU)."""
    module = ResNet([1, 1, 1, 1], num_classes=10)
    init_cnn_params(module, torch.Generator().manual_seed(0))
    variables = jax.tree_util.tree_map(jnp.asarray, cnn_params_to_flax(module))
    flax_module = jax_resnet.ResNet(stage_sizes=[1, 1, 1, 1], num_classes=10)
    jax_mf = ModelIngest.from_flax(flax_module, variables, input_shape=(32, 32, 3))
    return jax_mf, variables, ModelFunction.from_module(module, input_shape=(32, 32, 3), device="cpu")


def batches(n_steps, seed=0, valid=ROWS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        x = rng.normal(size=(ROWS, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, ROWS).astype(np.int32)
        mask = (np.arange(ROWS) < valid).astype(np.float32)
        out.append((x, y, mask))
    return out


def jax_loss(jax_mf):
    def loss(params, batch):
        bx, by, bm = batch
        per_ex = optax.softmax_cross_entropy_with_integer_labels(jax_mf.fn(params, bx), by)
        return jnp.sum(per_ex * bm) / jnp.maximum(jnp.sum(bm), 1.0)

    return loss


def port_loss(mf):
    def loss(params, batch):
        bx, by, bm = batch
        per_ex = F.cross_entropy(mf.apply(params, bx).float(), by.long(), reduction="none")
        return (per_ex * bm).sum() / torch.clamp(bm.sum(), min=1.0)

    return loss


def run_both(models, jax_opt, torch_opt, data, **step_kwargs):
    """Train both packages over ``data``; returns (JAX losses, port losses,
    [(path, JAX leaf, port leaf)])."""
    jax_mf, variables, mf = models
    mesh = jax_make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jax_kwargs = dict(step_kwargs)
    if "compute_dtype" in jax_kwargs:
        jax_kwargs["compute_dtype"] = jnp.bfloat16
    jax_step = jax_make_step(jax_loss(jax_mf), jax_opt, mesh, **jax_kwargs)
    jstate = jax_create_train_state(jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), variables), jax_opt)
    step = make_data_parallel_step(port_loss(mf), make_mesh(), **step_kwargs)
    state = create_train_state(mf.named_params(), torch_opt)
    jax_losses, losses = [], []
    for x, y, mask in data:
        jstate, jm = jax_step(jstate, (x, y, mask))
        state, m = step(state, tuple(torch.from_numpy(a) for a in (x, y, mask)))
        jax_losses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    ours = cnn_params_to_flax(mf.with_params(state.params).module)
    ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = jax.tree_util.tree_leaves_with_path(ours)
    assert [p for p, _ in ref] == [p for p, _ in got]
    return jax_losses, losses, [(p, a, b) for (p, a), (_, b) in zip(ref, got)]


def test_three_sgd_steps_hold_every_parameter_and_the_batchnorm_statistics(models):
    jax_losses, losses, leaves = run_both(
        models, optax.sgd(LR), functools.partial(torch.optim.SGD, lr=LR), batches(3)
    )
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    for path, a, b in leaves:
        np.testing.assert_allclose(b, a, atol=SGD_ATOL, err_msg=jax.tree_util.keystr(path))
    # the statistics moved, as the reference moves them
    _, variables, _ = models
    stats = {jax.tree_util.keystr(p): b for p, _, b in leaves if "batch_stats" in jax.tree_util.keystr(p)}
    initial = dict(
        (jax.tree_util.keystr(p), np.asarray(v))
        for p, v in jax.tree_util.tree_leaves_with_path(variables)
    )
    assert stats and any(np.abs(stats[k] - initial[k]).max() > 0 for k in stats)


def test_adam_holds_the_loss_history_and_the_parameters_with_real_gradients(models):
    _, _, mf = models
    data = batches(3, seed=1)
    # the first step's gradients, laid out as the flax tree
    params = {n: p.requires_grad_(True) for n, p in mf.named_params().items()}
    first = port_loss(mf)(params, tuple(torch.from_numpy(a) for a in data[0]))
    grads = dict(zip(params, torch.autograd.grad(first, list(params.values()))))
    grads = cnn_params_to_flax(mf.with_params(grads).module)
    jax_losses, losses, leaves = run_both(
        models, optax.adam(1e-3), functools.partial(torch.optim.Adam, lr=1e-3), data
    )
    np.testing.assert_allclose(losses, jax_losses, rtol=ADAM_LOSS_RTOL)
    g_leaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    held = 0
    for (path, a, b), g in zip(leaves, g_leaves):
        big = np.abs(g) >= ADAM_GRAD_FLOOR
        held += int(big.sum())
        np.testing.assert_allclose(b[big], a[big], atol=ADAM_ATOL, err_msg=jax.tree_util.keystr(path))
    assert held > 10_000


def test_grad_accumulation_with_a_padded_microbatch(models):
    """Two microbatches of 8 rows, the second holding 3 valid rows: the
    weighted accumulation equals the JAX package's."""
    weight = lambda b: b[2].sum()  # noqa: E731
    jax_mf, variables, mf = models
    data = batches(2, seed=2, valid=11)
    mesh = jax_make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jax_step = jax_make_step(
        jax_loss(jax_mf), optax.sgd(LR), mesh, grad_accum_steps=2,
        microbatch_weight_fn=lambda b: jnp.sum(b[2]),
    )
    jstate = jax_create_train_state(jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), variables), optax.sgd(LR))
    step = make_data_parallel_step(port_loss(mf), make_mesh(), grad_accum_steps=2, microbatch_weight_fn=weight)
    state = create_train_state(mf.named_params(), functools.partial(torch.optim.SGD, lr=LR))
    plain = make_data_parallel_step(port_loss(mf), make_mesh())
    plain_state = create_train_state(mf.named_params(), functools.partial(torch.optim.SGD, lr=LR))
    for x, y, mask in data:
        jstate, jm = jax_step(jstate, (x, y, mask))
        batch = tuple(torch.from_numpy(a) for a in (x, y, mask))
        state, m = step(state, batch)
        plain_state, pm = plain(plain_state, batch)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(m["loss"]) == pytest.approx(float(pm["loss"]), rel=1e-5)
    ours = cnn_params_to_flax(mf.with_params(state.params).module)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params), jax.tree_util.tree_leaves(ours)):
        np.testing.assert_allclose(b, np.asarray(a), atol=SGD_ATOL)
    for n, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), plain_state.params[n].detach().numpy(), atol=SGD_ATOL)


def test_bf16_compute_rounds_the_weights_the_forward_sees(models):
    jax_losses, losses, leaves = run_both(
        models, optax.sgd(LR), functools.partial(torch.optim.SGD, lr=LR), batches(2, seed=3),
        compute_dtype=torch.bfloat16,
    )
    np.testing.assert_allclose(losses, jax_losses, rtol=BF16_ATOL)
    for path, a, b in leaves:
        np.testing.assert_allclose(b, a, atol=BF16_ATOL, err_msg=jax.tree_util.keystr(path))
    # and bf16 really ran: the port's f32 step from the same start differs
    _, _, mf = models
    step = make_data_parallel_step(port_loss(mf), make_mesh())
    state = create_train_state(mf.named_params(), functools.partial(torch.optim.SGD, lr=LR))
    x, y, mask = batches(1, seed=3)[0]
    _, m = step(state, tuple(torch.from_numpy(a) for a in (x, y, mask)))
    assert float(m["loss"]) != losses[0]
