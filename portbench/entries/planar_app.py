"""Entry: the ``planar_intrinsics --fleet`` app, from detections JSON files
to the written report (BASELINE config 2 with gross outliers).

Traffic: ``fleets`` distinct fleets of ``sensors`` detections files, each
the bench.py set with its noise drawn from the seed and the fleet's index
and ``outliers`` points of every view moved by 20-40 px (``gen.displace``);
the config turns the RANSAC homography prefilter on. Call i runs
``main(["--fleet", "--device", ...])`` on fleet i mod ``fleets`` and
writes that fleet's report, so the last report of each fleet is on disk
when the window closes; a run writes a report per call, some MB each.

Judged against the plain reference on every sensor of each fleet's last
report (the same inputs give the same report, so a fleet's failures count
for each of its calls):

- ``mask_mismatches``: points whose prefilter verdict differs from the
  generator's: every displaced point rejected, every other point kept.
  An exact comparison.
- ``cost_gap``: the reference's float64 robust cost of the reported camera,
  with each view's pose at its best for that camera, against the
  reference's own minimum over camera and poses on the kept points,
  relative.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from portbench import gen, program
from portbench.reference import planar


def app_options(solver):
    """The planar-intrinsics config's options for ``solver``."""
    return {
        "optim_options": {"core": {"max_iterations": int(solver["max_iterations"]),
                                   "epsilon": float(solver["epsilon"]),
                                   "huber_delta": float(solver["huber_delta"]),
                                   "compute_covariance": bool(solver["compute_covariance"])}},
        "estim_options": {"homography_ransac": {}},
        "min_corners_per_view": int(solver["min_corners_per_view"]),
        "refine": True,
    }


class Entry:
    spans = (
        ("calibration_tpu_torch.pipeline.loaders:read_detections", "ingest"),
        ("calibration_tpu_torch.pipeline.facades.intrinsics:PlanarIntrinsicCalibrationFacade._prefilter",
         "prefilter"),
        ("calibration_tpu_torch.pipeline.facades.intrinsics:intrinsics_facade_batch", "schur"),
        ("calibration_tpu_torch.pipeline.reports:build_planar_intrinsics_report", "write"),
        ("calibration_tpu_torch.native:dumps_fast", "write"),
    )

    def __init__(self, cfg, traffic, seed, device, workdir):
        self.device = device
        self.fleets = int(traffic["fleets"])
        self.sensors = int(traffic["sensors"])
        shape = cfg["shapes"]
        solver = cfg["solver"]
        self.huber = float(solver["huber_delta"])
        self.inputs = []
        for k in range(self.fleets):
            directory = workdir / f"fleet{k}"
            directory.mkdir()
            config, features, displaced, obj, uv = gen.write_fleet(
                directory, self.sensors, seed=program.fleet_seed(seed, k, 1), outliers=int(traffic["outliers"]),
                noise_seed=program.fleet_seed(seed, k), options=app_options(solver))
            self.inputs.append({"config": config, "features": features, "displaced": displaced,
                                "obj": obj, "uv": uv, "report": str(workdir / f"report{k}.json")})
        self.views = shape["views"]
        self.truth_intr = np.tile(gen.BENCH_INTR, (self.sensors, 1))
        self.truth_poses = gen.bench_poses(self.sensors, self.views)
        self._reports = {}

    def call(self, i):
        from calibration_tpu_torch.apps import planar_intrinsics

        k = i % self.fleets
        f = self.inputs[k]
        program.run_main(planar_intrinsics.main, ["--fleet", "--device", self.device, "--config", f["config"],
                                                  "--features", *f["features"], "-o", f["report"]])
        self._reports.pop(k, None)
        return {"fleet": k}

    def report(self, k):
        if k not in self._reports:
            with open(self.inputs[k]["report"]) as fh:
                self._reports[k] = json.load(fh)["reports"][0]["cameras"]
        return self._reports[k]

    def outcome(self, out):
        cams = self.report(out["fleet"])
        return self.sensors, sum(not c["optimization"]["success"] for c in cams) + self.sensors - len(cams)

    def counters(self, kept):
        return {}

    def _tensors(self, k):
        f = self.inputs[k]
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        return t(f["obj"]), t(f["uv"]), t((~f["displaced"]).astype(np.float64))

    def reference_cost(self, k, dtype=torch.float64):
        """(camera, poses, cost) of fleet k on its clean points, solved from
        the truth by the reference in ``dtype``."""
        obj, uv, mask = self._tensors(k)
        return planar.solve(obj, uv, mask, torch.as_tensor(self.truth_intr, device=self.device),
                            torch.as_tensor(self.truth_poses, device=self.device), self.huber, dtype=dtype)

    def control(self, k):
        """Fleet k's report as the reference in float32 gives it: the
        generator's clean points kept, the float32 camera."""
        intr, _, _ = self.reference_cost(k, torch.float32)
        n = self.inputs[k]["displaced"].shape[-1]
        cams = []
        for i, cam in enumerate(intr.double().cpu().numpy()):
            keep = ~self.inputs[k]["displaced"][i]
            cams.append({"camera": {"kmtx": dict(zip(("fx", "fy", "cx", "cy", "skew"), map(float, cam[:5]))),
                                    "distortion": {"coeffs": [float(c) for c in cam[5:]]}},
                         "optimization": {"success": True},
                         "per_view": [{"homography": {"inliers": keep[j].tolist() + [False] * (n - keep.shape[1])}}
                                      for j in range(keep.shape[0])]})
        self._reports[k] = cams
        return {"fleet": k}

    def judge(self, kept):
        mismatches, cost_gap = 0, []
        for k in sorted({out["fleet"] for out in kept}):
            cams = self.report(k)
            displaced = self.inputs[k]["displaced"]
            n = displaced.shape[-1]
            if len(cams) != self.sensors:
                return {"mask_mismatches": float("inf"), "cost_gap": float("inf")}
            for i, cam in enumerate(cams):
                for j, view in enumerate(cam["per_view"]):
                    inl = np.asarray(view["homography"]["inliers"], bool)
                    mismatches += int((inl[:n] != ~displaced[i, j]).sum()) + int(inl[n:].sum())
            intr = torch.as_tensor([
                [c["camera"]["kmtx"][key] for key in ("fx", "fy", "cx", "cy", "skew")] + c["camera"]["distortion"]["coeffs"]
                for c in cams], dtype=torch.float64, device=self.device)
            obj, uv, mask = self._tensors(k)
            _, _, ref_cost = self.reference_cost(k)
            _, _, cost = planar.solve(obj, uv, mask, intr, torch.as_tensor(self.truth_poses, device=self.device),
                                      self.huber, intrinsics=False)
            cost_gap.append(((cost - ref_cost).abs() / ref_cost).max())
        return {"mask_mismatches": float(mismatches), "cost_gap": program.worst(cost_gap)}
