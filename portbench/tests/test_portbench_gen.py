"""The frozen generators equal chip_smoke.py's, from which they were
copied, at a small size."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import gen

chip_smoke = pytest.importorskip("chip_smoke")


def test_make_problems():
    for seed in (7, 12345):
        want = chip_smoke.make_problems(3, seed=seed)
        got = gen.make_problems(3, seed=seed)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)


def test_bundle_problems():
    want = chip_smoke.bundle_problems(3, num_obs=6, seed=23)
    got = gen.bundle_problems(3, num_obs=6, seed=23)
    for key, value in want.items():
        np.testing.assert_array_equal(value, got[key], err_msg=key)


def _files(directory):
    return {p.name: p.read_text() for p in sorted(directory.iterdir())}


def test_write_fleet(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    config_w, feat_w, disp_w = chip_smoke.write_fleet(tmp_path / "a", 3, seed=11)
    config_g, feat_g, disp_g, _, _ = gen.write_fleet(tmp_path / "b", 3, seed=11)
    np.testing.assert_array_equal(disp_w, disp_g)
    assert _files(tmp_path / "a") == _files(tmp_path / "b")
    assert json.loads((tmp_path / "b" / "config_3.json").read_text())["options"] == gen.FLEET_OPTIONS


def test_write_handeye_fleet(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = chip_smoke.write_handeye_fleet(tmp_path / "a", 3, seed=31)
    got = gen.write_handeye_fleet(tmp_path / "b", 3, seed=31)
    for key, value in want.items():
        if key != "input_path":
            np.testing.assert_array_equal(value, got[key], err_msg=key)
    assert _files(tmp_path / "a") == _files(tmp_path / "b")
