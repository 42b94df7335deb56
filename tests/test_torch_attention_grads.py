"""Gradients through the port's sequence parallelism
(``ops/ring_attention.py``, ``ops/ulysses.py``,
``models/bert.bert_model_function_sequence_parallel``) against the JAX
package's, on the CPU: ``tests/test_attention_grads.py``'s contract on
every rank.

World sizes 2 and 4 run as gloo process gangs (this file is their worker
script), world size 1 in process. Every rank gets the same q, k, v and
computes ``dq``, ``dk``, ``dv`` of one weighted sum over the replicated
output of ring and Ulysses attention, masked and unmasked; each must equal
``jax.grad`` of the JAX package's ``dense_attention`` within 2e-4
(``tests/test_attention_grads.py``'s oracle and tolerance). The JAX ring
and Ulysses gradients are not compiled here: that compile is why
``test_attention_grads.py`` is a slow file. Ulysses over the flash
kernel's plain version (the CPU's) differentiates too; on CUDA the kernel
has no backward and raises (``tests/test_torch_cuda.py``). Then bert-tiny,
sequence-parallel over the JAX package's weights: the parameter gradients
of a weighted sum of the pooled embeddings on every rank within 1e-4 of
``jax.grad`` of the JAX package's dense bert-tiny.
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

from sparkdl_tpu_torch.models import bert_model_function_sequence_parallel
from sparkdl_tpu_torch.ops import ring_attention_sharded, ulysses_attention_sharded
from sparkdl_tpu_torch.ops.flash_attention import make_flash_attention_fn
from sparkdl_tpu_torch.parallel import distributed, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, L, DH = 2, 8, 32, 32  # Dh 32: the flash kernel's least
MAX_LEN = 32
ATTN_TOL = 2e-4  # tests/test_attention_grads.py
BERT_TOL = 1e-4
STRATEGIES = ("ring", "ulysses", "ulysses_flash")


def _qkv():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(B, H, L, DH)).astype(np.float32) for _ in range(3)]


def _mask():
    """The JAX test's: the last 6 keys of every row masked."""
    m = np.zeros((B, 1, 1, L), np.float32)
    m[..., L - 6 :] = np.finfo(np.float32).min
    return m


def _ids():
    """[3, MAX_LEN] token ids with a padded tail, a short row and a fully
    padded row, and the matching 0/1 mask."""
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 1000, (3, MAX_LEN)).astype(np.int32)
    ids[0, 27:] = 0
    ids[1, 5:] = 0
    ids[2] = 0
    return ids, (ids != 0).astype(np.int32)


def _weights(shape):
    """A non-uniform weighting, so that every gradient is informative."""
    size = int(np.prod(shape))
    return np.arange(size, dtype=np.float32).reshape(shape) / size


def _port_attention_grads(strategy: str, masked: bool, mesh) -> list:
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv())
    mask = torch.from_numpy(_mask()) if masked else None
    if strategy == "ring":
        out = ring_attention_sharded(q, k, v, mask, mesh)
    else:
        inner = make_flash_attention_fn() if strategy == "ulysses_flash" else None
        out = ulysses_attention_sharded(q, k, v, mask, mesh, inner=inner)
    (out * torch.from_numpy(_weights(out.shape))).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


def _port_bert_grads(strategy: str, params, mesh) -> dict:
    mf = bert_model_function_sequence_parallel(
        "tiny", mesh=mesh, strategy=strategy, params=params, max_length=MAX_LEN, device="cpu",
    )
    named = {n: t.requires_grad_(True) for n, t in mf.named_params().items()}
    ids, attn = (torch.from_numpy(a) for a in _ids())
    out = mf.apply(named, (ids, attn))
    (out * torch.from_numpy(_weights(out.shape))).sum().backward()
    return {n: t.grad.numpy() for n, t in named.items()}


def _run_cases(world: int, params) -> dict:
    mesh = make_mesh({"sp": world})
    out = {}
    for strategy in STRATEGIES:
        for masked in (False, True):
            for name, g in zip("qkv", _port_attention_grads(strategy, masked, mesh)):
                out[f"{strategy}/{masked}/d{name}"] = g
    for strategy in ("ring", "ulysses"):
        for name, g in _port_bert_grads(strategy, params, mesh).items():
            out[f"bert/{strategy}/{name}"] = g
    return out


def _worker(rank: int, world: int, port: int, weights: str, out_path: str) -> None:
    from sparkdl_tpu_torch.models.registry import load_flax_npz

    distributed.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank, device="cpu")
    try:
        np.savez(out_path, **_run_cases(world, load_flax_npz(weights)))
    finally:
        distributed.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """bert-tiny's flax params from the JAX package, and the ``.npz`` the
    gang loads them from."""
    import jax
    import jax.numpy as jnp

    from sparkdl_tpu.models.bert import bert_tiny
    from sparkdl_tpu_torch.models.registry import save_flax_weights

    params = bert_tiny().init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("weights") / "bert_tiny.npz")
    save_flax_weights(params, path)
    return params, path


@pytest.fixture(scope="module", params=[1, 2, 4])
def gang(request, jax_weights, tmp_path_factory):
    """Every rank's gradients at world size ``request.param``."""
    world = request.param
    if world == 1:
        return world, [_run_cases(1, jax_weights[0])]
    tmp = tmp_path_factory.mktemp(f"gang{world}")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r), str(world), str(port),
             jax_weights[1], str(tmp / f"rank{r}.npz")],
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


@functools.lru_cache(maxsize=None)
def _jax_dense_grads(masked: bool):
    """``jax.grad`` of the JAX package's dense attention: the oracle."""
    import jax
    import jax.numpy as jnp

    from sparkdl_tpu.models.bert import dense_attention

    mask = jnp.asarray(_mask()) if masked else None

    def loss(q, k, v):
        out = dense_attention(q, k, v, mask, jnp.float32)
        return jnp.sum(out * _weights(out.shape))

    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in _qkv()))]


_JAX_BERT = {}


def _jax_bert_grads(params):
    """``jax.grad`` of the JAX package's dense bert-tiny over ``_ids()``, in
    the port's parameter names."""
    if "grads" not in _JAX_BERT:
        import jax
        import jax.numpy as jnp

        from sparkdl_tpu.models.bert import bert_model_function as jax_bert_mf
        from sparkdl_tpu_torch.models.bert import BERT_CONFIGS
        from sparkdl_tpu_torch.models.convert import bert_params_from_flax

        mf = jax_bert_mf("tiny", params=params, max_length=MAX_LEN)
        ids, attn = (jnp.asarray(a) for a in _ids())

        def loss(p):
            out = mf.fn(p, (ids, attn))
            return jnp.sum(out * _weights(out.shape))

        grads = jax.jit(jax.grad(loss))(jax.tree_util.tree_map(jnp.asarray, params))
        grads = jax.tree_util.tree_map(np.asarray, grads)
        _JAX_BERT["grads"] = {n: t.numpy() for n, t in bert_params_from_flax(grads, BERT_CONFIGS["tiny"]).items()}
    return _JAX_BERT["grads"]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("masked", [False, True])
def test_attention_grads_match_jax_dense_on_every_rank(gang, strategy, masked):
    _, outs = gang
    ref = _jax_dense_grads(masked)
    for r, out in enumerate(outs):
        for name, g in zip("qkv", ref):
            np.testing.assert_allclose(out[f"{strategy}/{masked}/d{name}"], g, rtol=ATTN_TOL, atol=ATTN_TOL,
                                       err_msg=f"rank {r} d{name}")


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_bert_tiny_parameter_grads_match_jax_dense(gang, jax_weights, strategy):
    """Each rank embeds its L/n tokens; the parameters enter its shard
    through ``copy_to_axis``, so every rank holds the dense gradient of every
    parameter, the embedding tables included."""
    _, outs = gang
    ref = _jax_bert_grads(jax_weights[0])
    for r, out in enumerate(outs):
        got = {k.split("/", 2)[2]: v for k, v in out.items() if k.startswith(f"bert/{strategy}/")}
        assert set(got) == set(ref)
        for name, g in ref.items():
            np.testing.assert_allclose(got[name], g, rtol=BERT_TOL, atol=BERT_TOL, err_msg=f"rank {r} {name}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=5, required=True, metavar=("RANK", "WORLD", "PORT", "WEIGHTS", "OUT"))
    rank, world, port, weights, out_path = parser.parse_args().worker
    _worker(int(rank), int(world), int(port), weights, out_path)
