"""The port's tensor, pipeline and expert parallelism
(``parallel/tensor_parallel.py``, ``pipeline_parallel.py``,
``expert_parallel.py``) and the data-parallel steps' ``axis`` against the
JAX package's, on the CPU.

World sizes 2 and 4 run as gloo process gangs (this file is their worker
script), world size 1 in process. Every rank gets the same numpy inputs,
runs each case forward and ``backward()`` of one loss over the replicated
output, and keeps its output and gradients. The JAX package runs the same
inputs through its functions on a mesh over the first n of conftest's 8
CPU devices, and ``jax.grad`` of the same loss. Every rank must hold the
JAX package's output and its whole gradient, at the JAX tests' own
tolerances (``tests/test_tensor_parallel.py``,
``test_pipeline_parallel.py``, ``test_expert_parallel.py``; the last
checks only that its gradients are finite, and the port's are held to
the JAX gradients at its output tolerance). The 2-D meshes are ``{"dp":
n // 2, "tp": 2}`` and ``{"dp": n // 2, "pp": 2}`` (``{"dp": 1, ...: n}``
below 4 processes). The data-parallel steps on ``{"dp": n // 2, "tp":
2}`` average over ``dp`` only, as the JAX steps built with
``axis="dp"``, and the ``DataParallelEstimator`` on ``{"dp": n // 2,
"sp": 2}`` splits its batches over ``dp`` and keeps the ``sp`` processes
as replicas, as the JAX estimator does on ``{"dp": 4, "sp": 2}`` over the
8 devices (on ``{"dp": 2, "sp": 2}`` it refuses 8 devices, as the port
refuses 8 processes).
"""

import argparse
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.parallel import (
    Mesh,
    create_train_state,
    distributed,
    make_data_parallel_step,
    make_eval_step,
    make_mesh,
    make_zero1_data_parallel_step,
    moe_apply,
    pipeline_apply,
    shard_dense_params,
    stack_stage_params,
    switch_route,
    tp_block_sharded,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_IN, D_FF, D_OUT = 16, 64, 16  # the TP block (tests/test_tensor_parallel.py)
D = 16  # the pipeline's width (tests/test_pipeline_parallel.py)
ED, E, T = 8, 8, 64  # the MoE's width, experts and tokens (tests/test_expert_parallel.py)
FWD = dict(rtol=1e-5, atol=1e-6)  # the TP and PP tests' output tolerance
GRAD = dict(rtol=1e-4, atol=1e-6)  # and their gradients'
MOE = dict(rtol=1e-4, atol=1e-5)  # the MoE test's output tolerance
LR = 0.1


def _data():
    """Every case's inputs, from one seed."""
    rng = np.random.default_rng(0)
    f = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)  # noqa: E731
    return {
        "tp/x": f(4, D_IN), "tp/x8": f(8, D_IN), "tp/w1": f(D_IN, D_FF, s=0.2), "tp/w2": f(D_FF, D_OUT, s=0.2),
        "tp/b1": f(D_FF, s=0.1), "tp/b2": f(D_OUT, s=0.1),
        "pp/w": f(4, D, D, s=0.3), "pp/b": f(4, D, s=0.1), "pp/x": f(16, D), "pp/x32": f(32, D), "pp/x8": f(8, D),
        "ep/router": f(ED, E, s=0.5), "ep/w1": f(E, ED, 2 * ED, s=0.3), "ep/w2": f(E, 2 * ED, ED, s=0.3),
        "ep/x": f(T, ED),
        "dp/w": f(4, 1), "dp/b": f(1), "dp/x": f(16, 4), "dp/y": f(16, 1),
        "est/w1": f(5, 16, s=0.4), "est/b1": f(16, s=0.1), "est/w2": f(16, 2, s=0.4), "est/b2": f(2, s=0.1),
        "est/x": np.concatenate([f(32, 5) + 1.0, f(32, 5) - 1.0]),
    }


EST = dict(inputCol="features", labelCol="label", outputCol="logits", batchSize=16, epochs=2)


def _est_columns(d):
    return {"features": list(d["est/x"]), "label": [0] * 32 + [1] * 32}


def _grid(axis: str, world: int) -> dict:
    return {"dp": max(1, world // 2), axis: min(2, world)}


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _stage_fn(params, h):
    # one residual MLP block, as tests/test_pipeline_parallel.py's
    return h + torch.tanh(h @ params["w"] + params["b"])


def _expert_fn(params, h):
    return F.relu(h @ params["w1"]) @ params["w2"]


def _run_cases(world: int) -> dict:
    """Every case at this world size; ``{name: numpy array}``."""
    d = _data()
    out = {}

    def keep(name, y, *leaves):
        """The output and the gradients of mean(y**2) over ``leaves``."""
        out[name] = y.detach().numpy()
        (y ** 2).mean().backward()
        for i, leaf in enumerate(leaves):
            out[f"{name}/d{i}"] = leaf.grad.numpy()

    # -- tensor parallelism
    tp = make_mesh({"tp": world})
    x, w1, w2 = (_t(d[k], True) for k in ("tp/x", "tp/w1", "tp/w2"))
    keep("tp", tp_block_sharded(x, w1, w2, tp), x, w1, w2)
    args = [_t(d[k], True) for k in ("tp/x", "tp/w1", "tp/w2", "tp/b1", "tp/b2")]
    keep("tp_bias", tp_block_sharded(*args[:3], tp, b1=args[3], b2=args[4]), *args)
    args = [_t(d[k], True) for k in ("tp/x8", "tp/w1", "tp/w2", "tp/b1", "tp/b2")]
    grid = make_mesh(_grid("tp", world))
    keep("tp_grid", tp_block_sharded(*args[:3], grid, b1=args[3], b2=args[4], dp_axis="dp"), *args)
    shards = shard_dense_params(*(_t(d[k]) for k in ("tp/w1", "tp/w2")), tp,
                                b1=_t(d["tp/b1"]), b2=_t(d["tp/b2"]))
    for name, shard in zip(("w1", "w2", "b1", "b2"), shards):
        out[f"tp_sharded/{name}"] = shard.numpy()
    out["tp_sharded"] = tp_block_sharded(_t(d["tp/x"]), shards[0], shards[1], tp, b1=shards[2], b2=shards[3]).numpy()
    # -- pipeline parallelism: as many stages as processes
    pp = make_mesh({"pp": world})
    stages = [{"w": _t(d["pp/w"][i]), "b": _t(d["pp/b"][i])} for i in range(world)]
    stacked = {k: v.requires_grad_(True) for k, v in stack_stage_params(stages).items()}
    x = _t(d["pp/x"], True)
    keep("pp", pipeline_apply(_stage_fn, stacked, x, pp), stacked["w"], stacked["b"], x)
    out["pp_more"] = pipeline_apply(_stage_fn, stack_stage_params(stages), _t(d["pp/x32"]), pp,
                                    n_microbatches=16).numpy()
    grid = make_mesh(_grid("pp", world))
    stacked = {k: v.requires_grad_(True) for k, v in stack_stage_params(stages[:min(2, world)]).items()}
    x = _t(d["pp/x8"], True)
    keep("pp_grid", pipeline_apply(_stage_fn, stacked, x, grid, n_microbatches=4, dp_axis="dp"),
         stacked["w"], stacked["b"], x)
    # -- expert parallelism
    ep = make_mesh({"ep": world})
    router, w1, w2 = (_t(d[k], True) for k in ("ep/router", "ep/w1", "ep/w2"))
    keep("ep", moe_apply(_expert_fn, router, {"w1": w1, "w2": w2}, _t(d["ep/x"]), ep, capacity=T), router, w1, w2)
    out["ep_drop"] = moe_apply(_expert_fn, torch.zeros(ED, E), {"w1": _t(d["ep/w1"]), "w2": _t(d["ep/w2"])},
                               _t(d["ep/x"]), ep, capacity=1).numpy()
    out["ep_default"] = moe_apply(_expert_fn, _t(d["ep/router"]), {"w1": _t(d["ep/w1"]), "w2": _t(d["ep/w2"])},
                                  _t(d["ep/x"]), ep, capacity_factor=1.0).numpy()
    # -- the data-parallel steps over 'dp' on a dp x tp mesh: each dp shard
    # feeds its rows, the tp processes are replicas
    grid = make_mesh(_grid("tp", world))
    n_dp, i_dp = grid.axis_size("dp"), grid.axis_index("dp")
    rows = slice(i_dp * 16 // n_dp, (i_dp + 1) * 16 // n_dp)
    batch = (_t(d["dp/x"][rows]), _t(d["dp/y"][rows]))
    params = {"w": _t(d["dp/w"]), "b": _t(d["dp/b"])}
    sgd = functools.partial(torch.optim.SGD, lr=LR)
    step = make_data_parallel_step(_dp_loss, grid)
    state = create_train_state(params, sgd)
    for _ in range(2):
        state, m = step(state, batch)
    out["dp/step"] = np.concatenate([state.params["w"].detach().numpy().ravel(), state.params["b"].detach().numpy()])
    out["dp/loss"] = m["loss"].numpy()
    step, init = make_zero1_data_parallel_step(_dp_loss, sgd, grid, params)
    state = init(params)
    for _ in range(2):
        state, m = step(state, batch)
    out["dp/zero1"] = np.concatenate([state.params["w"].detach().numpy().ravel(), state.params["b"].detach().numpy()])
    out["dp/eval"] = make_eval_step(lambda p, b: {"loss": _dp_loss(p, b)}, grid)(params, batch)["loss"].numpy()
    # -- the trainer on a dp x sp mesh
    from sparkdl_tpu_torch.dataframe import DataFrame
    from sparkdl_tpu_torch.estimators import DataParallelEstimator
    from sparkdl_tpu_torch.graph.function import ModelFunction

    seq = torch.nn.Sequential(torch.nn.Linear(5, 16), torch.nn.ReLU(), torch.nn.Linear(16, 2))
    with torch.no_grad():
        for lin, i in ((seq[0], 1), (seq[2], 2)):
            lin.weight.copy_(_t(d[f"est/w{i}"].T))
            lin.bias.copy_(_t(d[f"est/b{i}"]))
    est = DataParallelEstimator(model=ModelFunction.from_module(seq, input_shape=(5,), device="cpu"),
                                optimizer=functools.partial(torch.optim.SGD, lr=0.05), meshAxes=_grid("sp", world),
                                device="cpu", **EST)
    model = est.fit(DataFrame.fromColumns(_est_columns(d), numPartitions=4))
    trained = model.modelFunction.module
    out["est/params"] = np.concatenate([trained[i].weight.detach().numpy().T.ravel() for i in (0, 2)]
                                       + [trained[i].bias.detach().numpy() for i in (0, 2)])
    out["est/loss"] = np.array([h["loss"] for h in model.history])
    return out


def _dp_loss(params, batch):
    bx, by = batch
    return ((bx @ params["w"] + params["b"] - by) ** 2).mean()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, out_path: str) -> None:
    distributed.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank, device="cpu")
    try:
        np.savez(out_path, **_run_cases(world))
    finally:
        distributed.shutdown()


@pytest.fixture(scope="module", params=[1, 2, 4])
def gang(request, tmp_path_factory):
    """Every rank's results at world size ``request.param``."""
    world = request.param
    if world == 1:
        return world, [_run_cases(1)]
    tmp = tmp_path_factory.mktemp(f"gang{world}")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r), str(world), str(port),
             str(tmp / f"rank{r}.npz")],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    for p in procs:
        log, _ = p.communicate(timeout=240)
        assert p.returncode == 0, log
    outs = []
    for r in range(world):
        with np.load(str(tmp / f"rank{r}.npz")) as blob:
            outs.append({key: blob[key] for key in blob.files})
    return world, outs


# -- the JAX side ---------------------------------------------------------------


def _jax_mesh(axes: dict):
    import jax

    from sparkdl_tpu.parallel import make_mesh as jax_make_mesh

    return jax_make_mesh(axes, devices=jax.devices()[: int(np.prod(list(axes.values())))])


def _jax_grads(fn, *args):
    """fn(*args) and the gradients of mean(fn(*args)**2) over every arg."""
    import jax
    import jax.numpy as jnp

    def loss(*a):
        y = fn(*a)
        return jnp.mean(y ** 2), y

    (_, y), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    return np.asarray(y), [np.asarray(g) for g in grads]


@functools.lru_cache(maxsize=None)
def _jax_case(name: str, world: int):
    """The JAX package's (output, [gradients]) of case ``name`` at ``world``
    devices, computed once."""
    import jax
    import jax.numpy as jnp
    import optax

    from sparkdl_tpu.parallel import data_parallel as jdp
    from sparkdl_tpu.parallel.expert_parallel import moe_apply as jax_moe
    from sparkdl_tpu.parallel.pipeline_parallel import pipeline_apply as jax_pipeline
    from sparkdl_tpu.parallel.tensor_parallel import tp_block_sharded as jax_tp

    d = {k: jnp.asarray(v) for k, v in _data().items()}

    def stage(params, h):
        return h + jnp.tanh(h @ params["w"] + params["b"])

    def expert(params, h):
        return jax.nn.relu(h @ params["w1"]) @ params["w2"]

    if name == "tp":
        mesh = _jax_mesh({"tp": world})
        return _jax_grads(lambda x, w1, w2: jax_tp(x, w1, w2, mesh), d["tp/x"], d["tp/w1"], d["tp/w2"])
    if name in ("tp_bias", "tp_grid"):
        grid = name == "tp_grid"
        mesh = _jax_mesh(_grid("tp", world) if grid else {"tp": world})
        return _jax_grads(
            lambda x, w1, w2, b1, b2: jax_tp(x, w1, w2, mesh, b1=b1, b2=b2, dp_axis="dp" if grid else None),
            d["tp/x8" if grid else "tp/x"], d["tp/w1"], d["tp/w2"], d["tp/b1"], d["tp/b2"])
    if name in ("pp", "pp_grid"):
        grid = name == "pp_grid"
        stages = min(2, world) if grid else world
        mesh = _jax_mesh(_grid("pp", world) if grid else {"pp": world})
        kw = dict(n_microbatches=4, dp_axis="dp") if grid else {}
        return _jax_grads(lambda w, b, x: jax_pipeline(stage, {"w": w, "b": b}, x, mesh, **kw),
                          d["pp/w"][:stages], d["pp/b"][:stages], d["pp/x8" if grid else "pp/x"])
    if name == "pp_more":
        mesh = _jax_mesh({"pp": world})
        p = {"w": d["pp/w"][:world], "b": d["pp/b"][:world]}
        return np.asarray(jax.jit(lambda p, x: jax_pipeline(stage, p, x, mesh, n_microbatches=16))(p, d["pp/x32"])), []
    if name == "ep":
        mesh = _jax_mesh({"ep": world})
        return _jax_grads(lambda r, w1, w2: jax_moe(expert, r, {"w1": w1, "w2": w2}, d["ep/x"], mesh, capacity=T),
                          d["ep/router"], d["ep/w1"], d["ep/w2"])
    if name in ("ep_drop", "ep_default"):
        mesh = _jax_mesh({"ep": world})
        drop = name == "ep_drop"
        router = jnp.zeros((ED, E), jnp.float32) if drop else d["ep/router"]
        kw = dict(capacity=1) if drop else dict(capacity_factor=1.0)
        fn = jax.jit(lambda r, p, x: jax_moe(expert, r, p, x, mesh, **kw))
        return np.asarray(fn(router, {"w1": d["ep/w1"], "w2": d["ep/w2"]}, d["ep/x"])), []
    if name == "est":
        import flax.linen as fnn

        from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
        from sparkdl_tpu.estimators import DataParallelEstimator as JaxEstimator
        from sparkdl_tpu.graph.ingest import ModelIngest

        class MLP(fnn.Module):
            @fnn.compact
            def __call__(self, x):
                h = fnn.relu(fnn.Dense(16)(x))  # Dense_0
                return fnn.Dense(2)(h)  # Dense_1

        params = {"params": {f"Dense_{i}": {"kernel": d[f"est/w{i + 1}"], "bias": d[f"est/b{i + 1}"]}
                             for i in (0, 1)}}
        est = JaxEstimator(model=ModelIngest.from_flax(MLP(), params, input_shape=(5,)), optimizer=optax.sgd(0.05),
                           meshAxes={"dp": 4, "sp": 2}, **EST)
        model = est.fit(JaxDataFrame.fromColumns(_est_columns(_data()), numPartitions=4))
        p = model.modelFunction.params["params"]
        flat = np.concatenate([np.asarray(p[f"Dense_{i}"]["kernel"]).ravel() for i in (0, 1)]
                              + [np.asarray(p[f"Dense_{i}"]["bias"]) for i in (0, 1)])
        return flat, [np.array([h["loss"] for h in model.history])]
    # the data-parallel steps with axis="dp" on the dp x tp mesh
    mesh = _jax_mesh(_grid("tp", world))
    opt = optax.sgd(LR)
    params = {"w": d["dp/w"], "b": d["dp/b"]}
    batch = (d["dp/x"], d["dp/y"])

    def loss(p, b):
        bx, by = b
        return jnp.mean((bx @ p["w"] + p["b"] - by) ** 2)

    if name == "dp/eval":
        ev = jdp.make_eval_step(lambda p, b: {"loss": loss(p, b)}, mesh, axis="dp")
        return np.asarray(ev(params, batch)["loss"]), []
    if name == "dp/zero1":
        step, init = jdp.make_zero1_data_parallel_step(loss, opt, mesh, params, axis="dp", donate_state=False)
        state = init(params)
    else:
        step = jdp.make_data_parallel_step(loss, opt, mesh, axis="dp", donate_state=False)
        state = jdp.create_train_state(params, opt)
    for _ in range(2):
        state, m = step(state, batch)
    flat = np.concatenate([np.asarray(state.params["w"]).ravel(), np.asarray(state.params["b"])])
    return flat, [np.asarray(m["loss"])]


# -- the gangs against the JAX package ------------------------------------------


@pytest.mark.parametrize("case", ["tp", "tp_bias", "tp_grid"])
def test_tp_block_matches_jax(gang, case):
    """Output and the whole gradient of the input and every weight, on every
    rank: one all-reduce forward, the identity and the input's all-reduce
    in backward."""
    world, outs = gang
    ref, grads = _jax_case(case, world)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[case], ref, **FWD, err_msg=f"rank {r}")
        for i, g in enumerate(grads):
            np.testing.assert_allclose(out[f"{case}/d{i}"], g, **GRAD, err_msg=f"rank {r} d{i}")


def test_tp_pre_sharded_weights(gang):
    """``shard_dense_params`` gives each rank its column shard of w1 and b1
    and its row shard of w2, b2 whole, and the block over the shards equals
    the JAX block over the full weights."""
    world, outs = gang
    d = _data()
    ref, _ = _jax_case("tp_bias", world)
    c = D_FF // world
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["tp_sharded/w1"], d["tp/w1"][:, r * c : (r + 1) * c])
        np.testing.assert_array_equal(out["tp_sharded/w2"], d["tp/w2"][r * c : (r + 1) * c])
        np.testing.assert_array_equal(out["tp_sharded/b1"], d["tp/b1"][r * c : (r + 1) * c])
        np.testing.assert_array_equal(out["tp_sharded/b2"], d["tp/b2"])
        np.testing.assert_allclose(out["tp_sharded"], ref, **FWD, err_msg=f"rank {r}")


@pytest.mark.parametrize("case", ["pp", "pp_more", "pp_grid"])
def test_pipeline_matches_jax(gang, case):
    """The tick schedule's output and, where it is differentiated, the whole
    stacked gradient and the input's, on every rank."""
    world, outs = gang
    ref, grads = _jax_case(case, world)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[case], ref, **FWD, err_msg=f"rank {r}")
        for i, g in enumerate(grads):
            np.testing.assert_allclose(out[f"{case}/d{i}"], g, **GRAD, err_msg=f"rank {r} d{i}")


def test_pipeline_matches_the_sequential_stack(gang):
    world, outs = gang
    d = _data()
    h = _t(d["pp/x"])
    for i in range(world):
        h = _stage_fn({"w": _t(d["pp/w"][i]), "b": _t(d["pp/b"][i])}, h)
    for out in outs:
        np.testing.assert_allclose(out["pp"], h.numpy(), **FWD)


@pytest.mark.parametrize("case", ["ep", "ep_drop", "ep_default"])
def test_moe_matches_jax(gang, case):
    world, outs = gang
    ref, grads = _jax_case(case, world)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[case], ref, **MOE, err_msg=f"rank {r}")
        for i, g in enumerate(grads):
            assert np.isfinite(out[f"{case}/d{i}"]).all()
            np.testing.assert_allclose(out[f"{case}/d{i}"], g, **MOE, err_msg=f"rank {r} d{i}")
    if case == "ep":
        assert np.any(outs[0]["ep/d0"] != 0)  # the router is differentiable


def test_moe_matches_the_per_token_oracle(gang):
    """With ample capacity every token goes through its argmax expert times
    its gate."""
    _, outs = gang
    d = _data()
    x = torch.from_numpy(d["ep/x"])
    probs = torch.softmax(x @ torch.from_numpy(d["ep/router"]), dim=-1)
    chosen = probs.argmax(dim=-1)
    oracle = torch.stack([
        probs[t, chosen[t]] * _expert_fn({k: torch.from_numpy(d[f"ep/{k}"][chosen[t]]) for k in ("w1", "w2")},
                                         x[t : t + 1])[0]
        for t in range(T)
    ]).numpy()
    for out in outs:
        np.testing.assert_allclose(out["ep"], oracle, **MOE)


def test_moe_capacity_drops_to_exact_zero(gang):
    """A zero router sends every token to expert 0 (the first of equal
    logits) and capacity 1 keeps one token per rank's shard: every other
    row is exactly 0."""
    world, outs = gang
    per_shard = T // world
    for out in outs:
        y = out["ep_drop"]
        kept = [t for t in range(T) if t % per_shard == 0]
        assert all(np.any(y[t] != 0) for t in kept)
        assert not np.any(np.delete(y, kept, axis=0))


@pytest.mark.parametrize("case", ["dp/step", "dp/zero1", "dp/eval"])
def test_data_parallel_steps_reduce_over_their_axis(gang, case):
    """On ``{"dp": n // 2, "tp": 2}`` each dp shard feeds its rows and the tp
    processes are replicas: two SGD steps (replicated and ZeRO-1) and the
    eval metrics equal the JAX steps built with ``axis="dp"``."""
    world, outs = gang
    ref, extra = _jax_case(case, world)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[case], ref, rtol=1e-5, atol=1e-6, err_msg=f"rank {r}")
        if case == "dp/step":
            np.testing.assert_allclose(out["dp/loss"], extra[0], rtol=1e-5, atol=1e-6)


def test_estimator_splits_batches_over_dp_and_replicates_sp(gang):
    """Two SGD epochs of the trainer on ``{"dp": n // 2, "sp": 2}``: the
    weights and the loss history of the JAX estimator on ``{"dp": 4, "sp":
    2}``, on every rank (every shard full, so the mean of shard means is
    the global mean)."""
    _, outs = gang
    ref, (losses,) = _jax_case("est", 8)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["est/params"], ref, rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["est/loss"], losses, rtol=1e-5, err_msg=f"rank {r}")


# -- in process -----------------------------------------------------------------


def test_switch_route_matches_jax_ties_included():
    """The slots of arrival order, the capacity drop, the gates, and the
    first of tied experts, bit for bit."""
    import jax
    import jax.numpy as jnp

    from sparkdl_tpu.parallel.expert_parallel import switch_route as jax_route

    rng = np.random.default_rng(4)
    cases = [
        (np.asarray([[5.0, 0.0], [5.0, 0.0], [5.0, 0.0], [0.0, 5.0]], np.float32), 2, 2),
        (np.zeros((6, 4), np.float32), 4, 3),  # every logit tied: expert 0
        (np.asarray([[1.0, 3.0, 3.0], [2.0, 2.0, 0.0], [0.0, 1.0, 1.0]], np.float32), 3, 1),
        (rng.normal(size=(32, 8)).astype(np.float32), 8, 3),
    ]
    for logits, experts, capacity in cases:
        dispatch, combine = switch_route(torch.from_numpy(logits), experts, capacity)
        jd, jc = jax.jit(jax_route, static_argnums=(1, 2))(jnp.asarray(logits), experts, capacity)
        np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
        np.testing.assert_allclose(combine.numpy(), np.asarray(jc), rtol=1e-6, atol=0)
    dispatch, combine = switch_route(torch.from_numpy(cases[0][0]), num_experts=2, capacity=2)
    assert dispatch.shape == (4, 2, 2)
    assert dispatch[0, 0, 0] == 1 and dispatch[1, 0, 1] == 1 and dispatch[3, 1, 0] == 1
    assert not dispatch[2].any()  # token 2 overflows expert 0
    assert 0 < float(combine[0, 0, 0]) <= 1


def _jax_error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_geometry_errors_match_jax():
    """Each refusal of the JAX functions, with its wording, on a mesh record
    of 8 processes (every check runs before any collective)."""
    import jax.numpy as jnp

    from sparkdl_tpu.parallel.expert_parallel import moe_apply as jax_moe
    from sparkdl_tpu.parallel.pipeline_parallel import pipeline_apply as jax_pipeline
    from sparkdl_tpu.parallel.pipeline_parallel import stack_stage_params as jax_stack
    from sparkdl_tpu.parallel.tensor_parallel import tp_block_sharded as jax_tp

    d = _data()
    z = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731
    j = jnp.asarray
    stage = lambda p, h: h  # noqa: E731
    expert = lambda p, h: h  # noqa: E731
    stages4 = [{"w": z(D, D)} for _ in range(4)]
    stages8 = [{"w": z(D, D)} for _ in range(8)]
    params = {"w1": d["ep/w1"], "w2": d["ep/w2"]}
    # (the port's call, the JAX call, the JAX test's match)
    cases = [
        (lambda m: tp_block_sharded(_t(z(2, D_IN)), _t(z(D_IN, 60)), _t(z(60, D_OUT)), m),
         lambda m: jax_tp(j(z(2, D_IN)), j(z(D_IN, 60)), j(z(60, D_OUT)), m), {"tp": 8}, "divide over tp"),
        (lambda m: tp_block_sharded(_t(z(5, D_IN)), _t(d["tp/w1"]), _t(d["tp/w2"]), m, dp_axis="dp"),
         lambda m: jax_tp(j(z(5, D_IN)), j(d["tp/w1"]), j(d["tp/w2"]), m, dp_axis="dp"), {"dp": 2, "tp": 4},
         "dp_axis"),
        (lambda m: tp_block_sharded(_t(z(4, D_IN)), _t(d["tp/w1"]), _t(z(32, D_OUT)), m),
         lambda m: jax_tp(j(z(4, D_IN)), j(d["tp/w1"]), j(z(32, D_OUT)), m), {"dp": 2, "tp": 4}, "disagree"),
        (lambda m: pipeline_apply(stage, stack_stage_params([{"w": _t(s["w"])} for s in stages4]),
                                  _t(z(8, D)), m),
         lambda m: jax_pipeline(stage, jax_stack([{"w": j(s["w"])} for s in stages4]), j(z(8, D)), m),
         {"pp": 8}, "stages"),
        (lambda m: pipeline_apply(stage, stack_stage_params([{"w": _t(s["w"])} for s in stages8]),
                                  _t(z(9, D)), m),
         lambda m: jax_pipeline(stage, jax_stack([{"w": j(s["w"])} for s in stages8]), j(z(9, D)), m),
         {"pp": 8}, "divide"),
        (lambda m: pipeline_apply(stage, stack_stage_params([{"w": _t(s["w"])} for s in stages4]),
                                  _t(z(4, D)), m, n_microbatches=4, dp_axis="dp"),
         lambda m: jax_pipeline(stage, jax_stack([{"w": j(s["w"])} for s in stages4]), j(z(4, D)), m,
                                n_microbatches=4, dp_axis="dp"), {"dp": 2, "pp": 4}, "dp_axis"),
        (lambda m: moe_apply(expert, _t(d["ep/router"]), {k: _t(v) for k, v in params.items()}, _t(z(7, ED)), m),
         lambda m: jax_moe(expert, j(d["ep/router"]), {k: j(v) for k, v in params.items()}, j(z(7, ED)), m),
         {"ep": 8}, "Tokens"),
        (lambda m: moe_apply(expert, _t(z(ED, 6)), {k: _t(v) for k, v in params.items()}, _t(z(T, ED)), m),
         lambda m: jax_moe(expert, j(z(ED, 6)), {k: j(v) for k, v in params.items()}, j(z(T, ED)), m),
         {"ep": 8}, "num_experts"),
        (lambda m: moe_apply(expert, _t(d["ep/router"]), {"w": _t(z(6, 2))}, _t(z(T, ED)), m),
         lambda m: jax_moe(expert, j(d["ep/router"]), {"w": j(z(6, 2))}, j(z(T, ED)), m), {"ep": 8},
         "stacked"),
        (lambda m: moe_apply(expert, _t(d["ep/router"]), {}, _t(z(T, ED)), m),
         lambda m: jax_moe(expert, j(d["ep/router"]), {}, j(z(T, ED)), m), {"ep": 8}, "empty"),
    ]
    for port_call, jax_call, axes, match in cases:
        want = _jax_error(lambda: jax_call(_jax_mesh(axes)))
        got = _jax_error(lambda: port_call(Mesh(axes)))
        assert got == want and match in got, (got, want)


def test_chip_smoke_phase_28_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 28 at cut sizes on the CPU: bert-tiny, every
    check of the card's run (no flash launch on the CPU, where the
    Ulysses-over-flash model's backward is the plain version's)."""
    import chip_smoke

    for name, value in (("M_TEXT_MODEL", "bert-tiny"), ("M_TP_ROWS", 64), ("M_BATCH", 2), ("M_MAX_LENGTH", 32),
                        ("M_MICRO", 2), ("M_EP_TOKENS", 64), ("M_EP_DROP_CAPACITY", 4), ("M_SP_BATCH", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    assert chip_smoke.phase_model_parallel(0, "cpu", device="cpu") == {torch.float32: 0, torch.bfloat16: 0}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=4, required=True, metavar=("RANK", "WORLD", "PORT", "OUT"))
    rank, world, port, out_path = parser.parse_args().worker
    _worker(int(rank), int(world), int(port), out_path)
