#!/usr/bin/env python3
"""Write ``sparkdl_tpu_torch/models/keras_app_layers.py``: for each
``keras.applications`` architecture that ``sparkdl_tpu_torch.models.keras_weights``
maps, the weighted layers (Conv2D, DepthwiseConv2D, SeparableConv2D,
BatchNormalization, Dense) of ``<Arch>(weights=None)`` in the model's
layer order, as (Keras class, layer name), and how many of them the
top (``include_top=True``) adds.

The port has no keras, and a weights-only file (a Keras 3
``.weights.h5``, a legacy ``.h5`` weight file) holds no config: this list
is what maps such a file's layers onto an architecture. Needs keras
(any backend); run from the repository root:

    KERAS_BACKEND=jax python3 tools/keras_app_layers.py          # write
    KERAS_BACKEND=jax python3 tools/keras_app_layers.py --check  # compare
"""

from __future__ import annotations

import argparse
import os
import sys

ARCHS = ("ResNet50", "MobileNetV2", "InceptionV3", "Xception", "VGG16", "VGG19")
WEIGHTED = ("Conv2D", "DepthwiseConv2D", "SeparableConv2D", "BatchNormalization", "Dense")
#: the smallest input each architecture takes without its top
MIN_INPUT = {"InceptionV3": (75, 75, 3), "Xception": (71, 71, 3)}
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "sparkdl_tpu_torch", "models", "keras_app_layers.py")


def weighted_layers(model) -> list:
    """(class, name[, non-default BatchNormalization flags]) of each
    weighted layer of ``model``, in its config's order."""
    out = []
    for layer in model.get_config()["layers"]:
        cls, cfg = layer["class_name"], layer["config"]
        if cls not in WEIGHTED:
            continue
        flags = {k: False for k in ("scale", "center") if cls == "BatchNormalization" and cfg.get(k) is False}
        out.append((cls, cfg["name"], flags) if flags else (cls, cfg["name"]))
    return out


def build_table() -> dict:
    import keras

    table = {}
    for arch in ARCHS:
        app = getattr(keras.applications, arch)
        keras.backend.clear_session()  # fresh auto-numbered names
        top = weighted_layers(app(weights=None, include_top=True,
                                  **({} if arch.startswith("VGG") else {"input_shape": MIN_INPUT.get(arch, (32, 32, 3))})))
        keras.backend.clear_session()
        headless = weighted_layers(app(weights=None, include_top=False, input_shape=MIN_INPUT.get(arch, (32, 32, 3))))
        if top[:len(headless)] != headless:
            raise SystemExit(f"{arch}: the headless layers are not a prefix of the full model's")
        table[arch] = {"head": len(top) - len(headless), "layers": tuple(top)}
    return table


def render(table: dict) -> str:
    lines = [
        '"""The weighted layers of each keras.applications architecture the port',
        "maps, in layer order: (Keras class, layer name[, BatchNormalization",
        "flags that are not the default]), and how many the top adds.",
        "",
        "Written by ``tools/keras_app_layers.py`` from keras.applications",
        '(``<Arch>(weights=None)``); do not edit by hand."""',
        "",
        "KERAS_APP_LAYERS = {",
    ]
    for arch, entry in table.items():
        lines.append(f"    {arch!r}: {{")
        lines.append(f"        \"head\": {entry['head']},")
        lines.append("        \"layers\": (")
        for layer in entry["layers"]:
            lines.append(f"            {layer!r},")
        lines.append("        ),")
        lines.append("    },")
    lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="compare with the committed file, write nothing")
    args = ap.parse_args(argv)
    text = render(build_table())
    if args.check:
        with open(OUT) as f:
            same = f.read() == text
        print("keras_app_layers.py is up to date" if same else "keras_app_layers.py differs from keras")
        return 0 if same else 1
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
