"""Port equivalence of the planar-intrinsics front end on the committed
example data (examples/data: 2 cameras x 10 views x 88 points), CPU,
float64: the ``planar_intrinsics`` app, serial and ``--fleet``, against the
JAX app; a one-stage ``CalibrationPipeline`` (``IntrinsicStage`` over
``JsonPlanarDatasetLoader``) against the JAX pipeline; and the native codec
and JSON writer against the JAX package's.

Bars (``torch_helpers.report_tolerance``): the same keys at every level,
every non-float equal (every positional ``field_N`` key included), the
linear K within 1e-9 relative, the refined camera within 1e-6 relative, the
final cost within 1e-7 relative, per-view errors within 1e-8 px, and the
LM report strings equal up to their printed numbers.
"""

import json
import time

import numpy as np
import pytest
import torch

from calibration_tpu import native as jnative
from calibration_tpu.apps import planar_intrinsics as japp
from calibration_tpu.pipeline import CalibrationPipeline as JPipeline
from calibration_tpu.pipeline import IntrinsicStage as JIntrinsicStage
from calibration_tpu.pipeline import JsonPlanarDatasetLoader as JLoader
from calibration_tpu.pipeline import PipelineContext as JContext
from calibration_tpu.pipeline.facades.intrinsics import load_calibration_config as jload_config
from calibration_tpu_torch import native as tnative
from calibration_tpu_torch.apps import planar_intrinsics as tapp
from calibration_tpu_torch.io import jsonio as tjsonio
from calibration_tpu_torch.pipeline import CalibrationPipeline as TPipeline
from calibration_tpu_torch.pipeline import IntrinsicStage as TIntrinsicStage
from calibration_tpu_torch.pipeline import JsonPlanarDatasetLoader as TLoader
from calibration_tpu_torch.pipeline import PipelineContext as TContext
from calibration_tpu_torch.pipeline.dataset import PlanarDetections as TDetections
from calibration_tpu_torch.pipeline.facades.intrinsics import load_calibration_config as tload_config
from calibration_tpu_torch.pipeline.loaders import read_detections
from torch_helpers import assert_reports_match, one_torch_thread  # noqa: F401

CONFIG = "examples/data/planar_intrinsics_config.json"
FEATURES = ["examples/data/detections_cam0.json", "examples/data/detections_cam1.json"]


def _argv(out, fleet):
    return ["--config", CONFIG, "--features", *FEATURES, "-o", str(out)] + (["--fleet"] if fleet else [])


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reports")
    out = {}
    for mode, fleet in (("serial", False), ("fleet", True)):
        assert japp.main(_argv(tmp / f"jax_{mode}.json", fleet)) == 0
        assert tapp.main(_argv(tmp / f"port_{mode}.json", fleet) + ["--device", "cpu"]) == 0
        out[mode] = tuple(json.loads((tmp / f"{who}_{mode}.json").read_text()) for who in ("jax", "port"))
    return out


@pytest.mark.parametrize("mode", ["serial", "fleet"])
def test_app_report_matches_jax(reports, mode):
    want, got = reports[mode]
    assert_reports_match(want, got)
    assert len(got["reports"][0]["cameras"]) == 2
    assert got["reports"][0]["options"] == want["reports"][0]["options"]  # key for key


def test_pipeline_intrinsic_stage_matches_jax():
    summaries = []
    for pipeline, stage, loader, context, load in (
        (JPipeline, JIntrinsicStage(), JLoader, JContext, jload_config),
        (TPipeline, TIntrinsicStage("cpu"), TLoader, TContext, tload_config),
    ):
        pipe = pipeline()
        pipe.add_stage(stage)
        ctx = context()
        ctx.set_intrinsics_config(load(CONFIG))
        ld = loader()
        for path in FEATURES:
            ld.add_entry(path)
        report = pipe.execute(ld, ctx)
        assert report.success and [s.name for s in report.stages] == ["intrinsics"]
        summaries.append(report.stages[0].summary)
    assert_reports_match(*summaries)


def test_app_refuses_a_missing_card(monkeypatch, capsys):
    """--device cuda without a card fails with the app's usual line; it
    never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tapp.main(["--config", CONFIG, "--features", *FEATURES, "--device", "cuda"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("Calibration failed: ") and "cuda" in err[-1]


@pytest.fixture(scope="module")
def jax_codec():
    """The JAX package's codec library. That package builds it in place in
    its own directory with no temporary name, so on a fresh checkout another
    test worker may be writing the file while this one loads it: the load
    fails and the package remembers the failure for the rest of the process.
    Such a failure is forgotten and the load retried, a bounded number of
    times, until the other worker's build is complete."""
    for _ in range(60):
        if jnative.get_lib() is not None:
            return jnative
        jnative._build_failed = False
        time.sleep(1.0)
    pytest.fail("the JAX package's native codec did not load")


@pytest.mark.parametrize("path", FEATURES)
def test_codec_matches_jax(jax_codec, path):
    assert tnative.available()
    want, got = jax_codec.load_detections_packed(path), tnative.load_detections_packed(path)
    assert got._fields == want._fields
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name
    # the codec path of the loaders reads what the reflection path reads
    fast = read_detections(path)
    slow = tjsonio.from_jsonable(json.loads(open(path).read()), TDetections)
    assert [im.file for im in fast.images] == [im.file for im in slow.images]
    for a, b in zip(fast.images, slow.images):
        for x, y in zip(a.arrays(), b.arrays()):
            np.testing.assert_array_equal(x, y)
    assert (fast.sensor_id, fast.tags, fast.metadata) == (slow.sensor_id, slow.tags, slow.metadata)


@pytest.mark.parametrize("indent", [None, 2])
def test_dumps_fast_matches_json(indent):
    payload = json.loads(open(FEATURES[0]).read())
    payload["extra"] = [1e-300, -0.0, 3.141592653589793, "café \\ \"q\"", None, True, {"k": []}]
    want = json.dumps(payload, indent=indent)
    assert tnative.dumps_fast(payload, indent=indent) == want
    assert jnative.dumps_fast(payload, indent=indent) == want


def test_loader_reads_legacy_positional_payloads(tmp_path):
    """A payload with only positional field_N keys (the reference's legacy
    JSON) loads through the reflection path to what the JAX loader reads."""
    legacy = {
        "field_4": "legacyCam",
        "field_8": [
            {"field_0": f"{k}.png", "field_1": [
                {"field_0": 9.0 + j, "field_1": 8.0, "field_2": j, "field_3": 0.5 * j,
                 "field_4": 0.25, "field_5": 0.0}
                for j in range(3 + k)
            ]}
            for k in range(2)
        ],
    }
    path = tmp_path / "legacy.json"
    path.write_text(json.dumps(legacy))
    datasets = []
    for loader_cls in (TLoader, JLoader):
        loader = loader_cls()
        loader.add_entry(path)
        datasets.append(loader.load())
    (g,), (w,) = (d.planar_cameras for d in datasets)
    assert g.sensor_id == w.sensor_id == "legacyCam"
    assert [im.file for im in g.images] == [im.file for im in w.images] == ["0.png", "1.png"]
    for a, b in zip(g.images, w.images):
        for x, y in zip(a.arrays(), b.arrays()):
            np.testing.assert_array_equal(x, y)


def test_to_jsonable_takes_tensors():
    value = {"a": torch.tensor([[1.0, 2.0]], requires_grad=True), "b": torch.tensor(3)}
    assert tjsonio.to_jsonable(value) == {"a": [[1.0, 2.0]], "b": 3}
