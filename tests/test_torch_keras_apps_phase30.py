"""``chip_smoke.py`` phase 30 rehearsed on the CPU (``device="cpu"``,
the counts cut): every family translated from its committed config under
the phase's seeded weights, EfficientNetB0 through
``KerasImageFileTransformer`` over a few files, each family held against
Keras's stored outputs at the phase's limit, and the fine-tune's checks
(losses finite, the SE convs, BatchNorms and head moved, the
Normalization's statistics kept); zero flash launches."""

import pytest

from test_torch_keras_apps import chip_smoke, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_chip_smoke_phase_30_rehearses_on_the_cpu(monkeypatch, capsys, tmp_path):
    cs = chip_smoke()
    for name, value in (("KERAS_APPS_JPEGS", 4), ("KERAS_PNGS", 1), ("KERAS_BATCH", 4), ("KERAS_PARTITIONS", 2),
                        ("KERAS_APPS_BATCH", 2), ("KERAS_APPS_ITERS", 1), ("KERAS_APPS_FT_ROWS", 4),
                        ("KERAS_APPS_FT_BATCH", 2)):
        monkeypatch.setattr(cs, name, value)
    assert cs.phase_keras_apps(0, "cpu", str(tmp_path), device="cpu") == 0
    out = capsys.readouterr().out
    for name in cs.KERAS_APPS:
        assert f") {name} " in out, name
    assert out.count("(limit 0.0001)") == len(cs.KERAS_APPS)
    assert "the Normalization's statistics did not" in out and "flash launches 0" in out
