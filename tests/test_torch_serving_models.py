"""The port's serving path end to end against the JAX package's, on the
CPU, over registry-shaped models: ``bert-tiny`` embed requests with ragged
lengths from one flax tree (f32 atol 1e-4, as ``tests/test_torch_bert.py``),
ResNet50 at 32x32 from one flax tree (relative 1e-4, as
``tests/test_torch_image.py``), and the ``serve`` command on the CPU.
Shares the two-package surface of ``tests/test_torch_serving.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models import get_model
from sparkdl_tpu_torch.models.convert import cnn_params_from_flax
from sparkdl_tpu_torch.models.resnet import ResNet
from test_torch_serving import (  # noqa: F401  (_serving_env: the autouse fixture)
    BERT_ATOL,
    RESNET_REL,
    _both,
    _close,
    _http,
    _serving_env,
)


@pytest.fixture(scope="module")
def bert_tiny_weights(tmp_path_factory):
    """One flax tree of bert-tiny: a ``.npz`` for the JAX loader, the
    nested tree for the port's converter."""
    from sparkdl_tpu.models import bert as jax_bert

    params = jax_bert.bert_tiny().init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    path = str(tmp_path_factory.mktemp("bert") / "bert_tiny.npz")
    jax_registry.save_flax_weights(params, path)
    return path, params


def _bert_requests(seed=11, n=12):
    """Ragged embed requests: 1-3 rows each, lengths 5-60, pad id 0 after
    each row's own length."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        rows, length = int(rng.integers(1, 4)), int(rng.integers(5, 61))
        ids = rng.integers(4, 1000, size=(rows, length)).astype(np.int32)
        for r in range(rows):
            ids[r, int(rng.integers(1, length + 1)):] = 0
        reqs.append((ids, ("interactive", "batch")[i % 2]))
    return reqs


def test_bert_tiny_embed_requests_match_jax(bert_tiny_weights):
    path, params = bert_tiny_weights
    loaders = {
        "torch": lambda name, mode: get_model(name).model_function(
            mode=mode, params=params, device="cpu"),
        "jax": lambda name, mode: jax_registry.get_model(name).model_function(
            mode=mode, weights_file=path),
    }
    requests = _bert_requests()

    def run(side):
        router = side.router(loader=loaders[side.name])
        client = side.mod.ServingClient(router)
        try:
            reqs = [client.submit("bert-tiny", ids, priority=cls, mode="embed")
                    for ids, cls in requests]
            return [r.result(timeout=300) for r in reqs]
        finally:
            router.close()

    ours, ref = _both(run)
    direct = loaders["torch"]("bert-tiny", "embed")
    for (ids, _), a, b in zip(requests, ours, ref):
        assert a.shape == (len(ids), 128) and np.isfinite(a).all()
        _close(a, b, atol=BERT_ATOL)
        _close(a, direct(torch.from_numpy(ids)).numpy(), atol=BERT_ATOL)


def test_bert_tiny_over_http_matches_jax(bert_tiny_weights):
    path, params = bert_tiny_weights
    loaders = {
        "torch": lambda name, mode: get_model(name).model_function(
            mode=mode, params=params, device="cpu"),
        "jax": lambda name, mode: jax_registry.get_model(name).model_function(
            mode=mode, weights_file=path),
    }
    ids, _ = _bert_requests(seed=3, n=1)[0]

    def run(side):
        router = side.router(loader=loaders[side.name])
        server = side.mod.ServingServer(router, port=0)
        try:
            status, _, reply = _http(f"http://127.0.0.1:{server.port}", "/v1/predict", {
                "model": "bert-tiny", "inputs": ids.tolist(), "dtype": "int32",
                "mode": "embed", "priority": "batch"})
            assert status == 200
            return np.asarray(reply["outputs"], np.float32)
        finally:
            server.stop(close_router=True)

    ours, ref = _both(run)
    _close(ours, ref, atol=BERT_ATOL)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_resnet50_32px_features_match_jax():
    """ResNet50 at 32x32 through a custom loader in both packages: NHWC
    rows on the wire, the port's device fn hands the module NCHW."""
    jmod = jax_resnet.ResNet(stage_sizes=(3, 4, 6, 3))
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def port_loader(name, mode):
        module = ResNet((3, 4, 6, 3))
        module.load_state_dict(cnn_params_from_flax(variables, module))
        module = module.cast_compute().to(memory_format=torch.channels_last).eval()
        return ModelFunction(lambda m, x: m(x, features_only=True), module,
                             torch.device("cpu"), name=name, input_shape=(32, 32, 3))

    apply = jax.jit(lambda v, x: jmod.apply(v, x, features_only=True))

    def jax_loader(name, mode):
        return JaxModelFunction(apply, variables, input_shape=(32, 32, 3), name=name)

    loaders = {"torch": port_loader, "jax": jax_loader}
    rng = np.random.default_rng(8)
    images = [rng.normal(0, 60, size=(n, 32, 32, 3)).astype(np.float32) for n in (1, 2, 2, 1)]

    def run(side):
        router = side.router(loader=loaders[side.name])
        try:
            reqs = [side.mod.Request("resnet50-32", x, priority="interactive") for x in images]
            for r in reqs:  # one group, one rung
                router.queue.put(r)
            router.start()
            return [r.result(timeout=300) for r in reqs]
        finally:
            router.close()

    ours, ref = _both(run)
    for x, a, b in zip(images, ours, ref):
        assert a.shape == (len(x), 2048)
        assert _rel(a, b) <= RESNET_REL
        assert _rel(a, np.asarray(apply(variables, x))) <= RESNET_REL



def test_serve_cli_on_the_cpu_answers_over_http():
    """``python -m sparkdl_tpu_torch.serving serve --device cpu``: the
    process prints its port, answers /healthz and a bert-tiny embed, and
    stops on SIGINT."""
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparkdl_tpu_torch.serving", "serve", "--port", "0",
         "--device", "cpu", "--seed", "3"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        up = json.loads(proc.stdout.readline())
        assert up["serving"] == "up" and up["device"] == "cpu"
        base = f"http://127.0.0.1:{up['port']}"
        assert _http(base, "/healthz")[2]["status"] == "ok"
        ids = np.array([[7, 8, 9, 0, 0]], np.int32)
        status, _, reply = _http(base, "/v1/predict", {
            "model": "bert-tiny", "inputs": ids.tolist(), "dtype": "int32", "mode": "embed"})
        assert status == 200
        want = get_model("bert-tiny").model_function(device="cpu", seed=3)(torch.from_numpy(ids))
        _close(reply["outputs"], want.numpy(), atol=BERT_ATOL)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
            proc.stderr.close()
    assert proc.returncode == 0
