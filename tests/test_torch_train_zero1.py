"""ZeRO-1, the elementwise-optimizer probe, and two processes over gloo.

- The port's ZeRO-1 step (optimizer state for this process's slice of the
  flattened parameters) trains to the plain step's parameters.
- The build-time probe refuses an optimizer whose update of an element
  depends on the others (global-norm clipping), as the JAX probe refuses
  its optax counterpart, and accepts SGD and Adam.
- Two processes in a gloo process group, each with its own half of every
  global batch, against the JAX step on a two-device mesh (``dp=2``), for
  the plain and the ZeRO-1 step: the average of the two shard means and
  the reduce-scatter/all-gather path equal ``pmean`` / ``psum_scatter``.
  SGD is held element by element at atol 1e-5 (summation order only).

The same small ResNet as ``tests/test_torch_train_step.py``. Run as a
script (``python tests/test_torch_train_zero1.py --worker ...``) this file
is one of the two gloo processes.
"""

import argparse
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models.convert import cnn_params_to_flax
from sparkdl_tpu_torch.models.layers import init_cnn_params
from sparkdl_tpu_torch.models.resnet import ResNet
from sparkdl_tpu_torch.parallel import (
    create_train_state,
    distributed,
    make_data_parallel_step,
    make_mesh,
    make_zero1_data_parallel_step,
)
from sparkdl_tpu_torch.parallel.data_parallel import _assert_elementwise_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
LR = 0.01
ROWS = 16
STEPS = 2


def _port_model(seed=0):
    module = ResNet([1, 1, 1, 1], num_classes=10)
    init_cnn_params(module, torch.Generator().manual_seed(seed))
    return ModelFunction.from_module(module, input_shape=(32, 32, 3), device="cpu")


def _batches(seed=0, valid=ROWS):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(STEPS, ROWS, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (STEPS, ROWS)).astype(np.int32)
    mask = np.broadcast_to((np.arange(ROWS) < valid).astype(np.float32), (STEPS, ROWS)).copy()
    return x, y, mask


def _port_loss(mf):
    def loss(params, batch):
        bx, by, bm = batch
        per_ex = F.cross_entropy(mf.apply(params, bx).float(), by.long(), reduction="none")
        return (per_ex * bm).sum() / torch.clamp(bm.sum(), min=1.0)

    return loss


def _train(mf, step_fn, state, data, rows=slice(None)):
    x, y, mask = data
    losses = []
    for k in range(x.shape[0]):
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a[k][rows])) for a in (x, y, mask))
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    return state, losses


class _ClipByGlobalNorm(torch.optim.SGD):
    """SGD after clipping the gradient to a global norm of 1: an update of
    one element depends on every other element's gradient."""

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        return super().step(closure)


def test_zero1_step_matches_the_plain_step():
    mf = _port_model()
    data = _batches(seed=4, valid=13)
    adam = functools.partial(torch.optim.Adam, lr=1e-3)
    plain, plain_losses = _train(
        mf, make_data_parallel_step(_port_loss(mf), make_mesh()),
        create_train_state(mf.named_params(), adam), data,
    )
    step, init = make_zero1_data_parallel_step(_port_loss(mf), adam, make_mesh(), mf.named_params())
    zero1, zero1_losses = _train(mf, step, init(mf.named_params()), data)
    assert zero1.step == plain.step == STEPS
    np.testing.assert_allclose(zero1_losses, plain_losses, rtol=1e-6)
    for n, p in plain.params.items():
        np.testing.assert_allclose(zero1.params[n].detach().numpy(), p.detach().numpy(), atol=1e-6, err_msg=n)
    # the optimizer holds one flat vector: this process's whole slice
    [held] = zero1.optimizer.param_groups[0]["params"]
    assert held is zero1.shard and held.numel() >= sum(p.numel() for p in plain.params.values())


def test_elementwise_probe_refuses_a_global_norm_optimizer_as_the_jax_probe_does():
    import optax

    from sparkdl_tpu.parallel.data_parallel import _assert_elementwise_optimizer as jax_probe

    for ok in (functools.partial(torch.optim.SGD, lr=0.1), functools.partial(torch.optim.Adam, lr=1e-3)):
        _assert_elementwise_optimizer(ok)
    jax_probe(optax.adam(1e-3))
    with np.testing.assert_raises_regex(ValueError, "ELEMENTWISE"):
        _assert_elementwise_optimizer(functools.partial(_ClipByGlobalNorm, lr=0.1))
    with np.testing.assert_raises_regex(ValueError, "ELEMENTWISE"):
        jax_probe(optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(0.1)))
    # an optimizer that cannot step a bare tensor is refused, naming why
    with np.testing.assert_raises_regex(ValueError, "probing this one failed"):
        _assert_elementwise_optimizer(functools.partial(torch.optim.LBFGS, lr=0.1))
    step, _ = make_zero1_data_parallel_step(
        lambda p, b: p["x"].sum(), functools.partial(_ClipByGlobalNorm, lr=0.1), make_mesh(),
        {"x": torch.zeros(3)}, validate_elementwise=False,
    )
    assert callable(step)


def test_gradients_are_laid_out_as_their_parameters():
    """A channels_last conv weight gets a channels_last gradient: the
    optimizer's multi-tensor kernels take only matching strides."""
    from sparkdl_tpu_torch.parallel.data_parallel import _grad_buffer

    w = torch.randn(8, 3, 3, 3).contiguous(memory_format=torch.channels_last)
    b = torch.randn(8)
    flat, views = _grad_buffer([w, b])
    assert flat.numel() == w.numel() + b.numel() + 1
    assert views[0].stride() == w.stride() and views[1].stride() == b.stride()
    views[0].copy_(torch.ones_like(w))
    views[1].copy_(torch.full_like(b, 2.0))
    assert flat[: w.numel()].eq(1).all() and flat[w.numel() : -1].eq(2).all()
    mf = ModelFunction.from_module(torch.nn.Conv2d(3, 4, 3), device="cpu")
    state = create_train_state(mf.named_params(), functools.partial(torch.optim.SGD, lr=0.1))
    step = make_data_parallel_step(lambda p, batch: mf.apply(p, batch[0]).sum(), make_mesh())
    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, m = step(state, (torch.ones(2, 3, 5, 5),))
    assert state.step == 1 and float(m["grad_norm"]) > 0
    assert all(not torch.equal(before[n], p) for n, p in state.params.items())


def _flat(tree, prefix=""):
    """A nested dict of arrays as ``{"a/b/c": array}``."""
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, data_path: str, out_path: str) -> None:
    """One gloo process: its half of every batch through the plain and the
    ZeRO-1 step (SGD); writes the trained parameters as flax trees."""
    distributed.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank, device="cpu")
    try:
        mesh = make_mesh()
        assert mesh.size == world and mesh.rank == rank
        with np.load(data_path) as blob:
            data = (blob["x"], blob["y"], blob["mask"])
        local = ROWS // world
        rows = slice(rank * local, (rank + 1) * local)
        mf = _port_model()
        sgd = functools.partial(torch.optim.SGD, lr=LR)
        plain, plain_losses = _train(
            mf, make_data_parallel_step(_port_loss(mf), mesh),
            create_train_state(mf.named_params(), sgd), data, rows,
        )
        step, init = make_zero1_data_parallel_step(_port_loss(mf), sgd, mesh, mf.named_params())
        zero1, zero1_losses = _train(mf, step, init(mf.named_params()), data, rows)
        flat = {}
        for arm, state, losses in (("plain", plain, plain_losses), ("zero1", zero1, zero1_losses)):
            flat.update(_flat(cnn_params_to_flax(mf.with_params(state.params).module), arm))
            flat[f"{arm}/losses"] = np.asarray(losses)
        np.savez(out_path, **flat)
    finally:
        distributed.shutdown()


def test_two_gloo_processes_match_jax_on_a_two_device_mesh(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    from sparkdl_tpu.graph.ingest import ModelIngest
    from sparkdl_tpu.models import resnet as jax_resnet
    from sparkdl_tpu.parallel import (
        create_train_state as jax_create_train_state,
        make_data_parallel_step as jax_make_step,
        make_mesh as jax_make_mesh,
        make_zero1_data_parallel_step as jax_make_zero1,
    )

    data = _batches(seed=5)
    data_path = str(tmp_path / "data.npz")
    np.savez(data_path, x=data[0], y=data[1], mask=data[2])
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r), "2", str(port),
             data_path, str(tmp_path / f"rank{r}.npz")],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    # the JAX side meanwhile
    variables = jax.tree_util.tree_map(jnp.asarray, cnn_params_to_flax(_port_model().module))
    jax_mf = ModelIngest.from_flax(
        jax_resnet.ResNet(stage_sizes=[1, 1, 1, 1], num_classes=10), variables, input_shape=(32, 32, 3)
    )

    def loss(params, batch):
        bx, by, bm = batch
        per_ex = optax.softmax_cross_entropy_with_integer_labels(jax_mf.fn(params, bx), by)
        return jnp.sum(per_ex * bm) / jnp.maximum(jnp.sum(bm), 1.0)

    mesh = jax_make_mesh({"dp": 2}, devices=jax.devices()[:2])
    copy = lambda: jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), variables)  # noqa: E731
    arms = {
        "plain": (jax_make_step(loss, optax.sgd(LR), mesh), jax_create_train_state(copy(), optax.sgd(LR))),
    }
    zstep, zinit = jax_make_zero1(loss, optax.sgd(LR), mesh, variables)
    arms["zero1"] = (zstep, zinit(copy()))
    ref = {}
    for arm, (step, state) in arms.items():
        losses = []
        for k in range(STEPS):
            state, m = step(state, tuple(a[k] for a in data))
            losses.append(float(m["loss"]))
        ref[arm] = (jax.tree_util.tree_map(np.asarray, state.params), losses)

    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
    with np.load(str(tmp_path / "rank0.npz")) as r0, np.load(str(tmp_path / "rank1.npz")) as r1:
        assert sorted(r0.files) == sorted(r1.files)
        for k in r0.files:  # the replicas agree
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        for arm, (tree, losses) in ref.items():
            np.testing.assert_allclose(r0[f"{arm}/losses"], losses, rtol=1e-5)
            leaves = _flat(tree, arm)
            assert sorted(leaves) == sorted(k for k in r0.files if k.startswith(arm + "/") and k != f"{arm}/losses")
            for k, v in leaves.items():
                np.testing.assert_allclose(r0[k], v, atol=ATOL, err_msg=k)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=5, required=True,
                        metavar=("RANK", "WORLD", "PORT", "DATA", "OUT"))
    rank, world, port, data_path, out_path = parser.parse_args().worker
    _worker(int(rank), int(world), int(port), data_path, out_path)
