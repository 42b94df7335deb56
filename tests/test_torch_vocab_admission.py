"""Out-of-vocabulary token ids at the port's admission, on the CPU.

An id outside ``[0, vocab_size)`` of a registry text model is refused at
admission on both paths, embed and generate: HTTP 400 naming the id and
the vocabulary, nothing reserved, no model loaded, and the next request
served as before. This is the port's one intended difference from the
JAX package, whose gathers clamp such an id and answer with rows of the
clamped token; the tests show that behaviour beside the port's (on CUDA
the port's gather would raise a device-side assert instead, which leaves
the CUDA context unusable for every later request).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import sparkdl_tpu.serving as jax_serving
from sparkdl_tpu.serving import router as jax_router
from sparkdl_tpu_torch.runtime import feeder
from sparkdl_tpu_torch.serving import Router, ServingServer
from sparkdl_tpu_torch.serving import router as port_router

MODEL = "bert-tiny"
VOCAB = 1000
BAD = ([5, 7, 1000], [5, -3, 7])


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("SPARKDL_INFERENCE_MODE", "roundrobin")
    monkeypatch.setenv("SPARKDL_INFERENCE_DEVICES", "1")
    monkeypatch.delenv("SPARKDL_SERVE_HBM_BUDGET_MB", raising=False)
    yield
    feeder.shutdown_feeders()


def _post(base, body):
    req = urllib.request.Request(base + "/v1/predict", data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("ids", BAD, ids=["past-the-vocabulary", "negative"])
def test_admission_functions_name_the_id_and_the_vocabulary(ids):
    bad = [i for i in ids if not 0 <= i < VOCAB][0]
    for payload in (np.asarray([ids], np.int64), np.asarray([ids], np.float32)):
        with pytest.raises(ValueError, match=rf"token id {bad}\b.*\[0, {VOCAB}\)"):
            port_router._bucket_token_payload(MODEL, payload)
        with pytest.raises(ValueError, match=rf"token id {bad}\b.*vocab_size {VOCAB}"):
            port_router._validate_generate(MODEL, payload, {"max_new_tokens": 4})
    # a wide id cannot wrap into range through the int32 cast
    with pytest.raises(ValueError, match=r"token id 4294967301"):
        port_router._bucket_token_payload(MODEL, np.asarray([[5, 2**32 + 5]], np.int64))
    # the JAX package admits the same payloads (its gathers clamp)
    assert jax_router._bucket_token_payload(MODEL, np.asarray([ids]))[0].shape[0] == 1
    assert jax_router._validate_generate(MODEL, np.asarray([ids]), {"max_new_tokens": 4})[1] == 3


def test_out_of_vocabulary_requests_get_400_and_reserve_nothing():
    router = Router(device="cpu")
    server = ServingServer(router, port=0)
    base = f"http://127.0.0.1:{server.port}"
    good = {"model": MODEL, "mode": "embed", "dtype": "int32", "inputs": [[5, 6, 7, 0]]}
    try:
        for ids in BAD:
            for mode in ("embed", "generate"):
                body = {"model": MODEL, "mode": mode, "dtype": "int32", "inputs": [ids]}
                if mode == "generate":
                    body["max_new_tokens"] = 4
                status, reply = _post(base, body)
                assert status == 400, (ids, mode, reply)
                assert "vocabulary" in reply["error"] and str(VOCAB) in reply["error"]
                assert router.residency.kv_reserved_bytes() == 0
        assert router.stats()["models"] == []  # refused before anything loaded
        status, before = _post(base, good)
        assert status == 200
        status, _ = _post(base, {**good, "inputs": [BAD[0]]})
        assert status == 400
        status, after = _post(base, good)
        assert status == 200 and after["outputs"] == before["outputs"]
        status, reply = _post(base, {"model": MODEL, "mode": "generate", "dtype": "int32",
                                     "inputs": [5, 6, 7], "max_new_tokens": 4})
        assert status == 200 and len(reply["tokens"][0]) == 4
        assert router.residency.kv_reserved_bytes() == 0
    finally:
        server.stop(close_router=True)


def test_the_jax_package_answers_the_same_ids():
    """The reference's behaviour, which the port deliberately does not
    follow: the request is answered, over the clamped token."""
    router = jax_serving.Router()
    try:
        out = router.submit(MODEL, np.asarray([BAD[0]], np.int32), mode="embed").result(timeout=120)
        assert np.asarray(out).shape == (1, 128)
    finally:
        router.close()
