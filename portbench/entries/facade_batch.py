"""Entry: ``intrinsics_facade_batch`` on a fleet of planar sensors held in
memory (BASELINE config 2; ``calibrate_many`` / ``IntrinsicStage`` callers
that already hold their detections).

Traffic: ``fleets`` distinct fleets of ``sensors`` sensors, each the
bench.py problem set with its pixel noise drawn from the seed and the
fleet's index; call i solves fleet i mod ``fleets``. A call is the
facade's whole solve: Zhang seed, planar poses, the phased Schur LM,
covariance, and the QA recheck (one K1 launch).

Judged against the plain reference (``reference.planar``), on every
sensor of every call of the window:

- ``cost_gap``: the reference's float64 robust cost at the program's
  camera and poses against the reference's own minimum, relative.
- ``cov_gap``: the variances of the 9 free camera parameters from the
  program's covariance against the reference's at its own minimum,
  relative.
- ``qa_gap_px``: K1's float32 per-view RMS against the reference's
  float64 RMS at the program's solution, in pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import gen, program
from portbench.reference import planar


class Entry:
    spans = (("calibration_tpu_torch.parallel.batched:intrinsics_facade_batch", "schur"),)

    def __init__(self, cfg, traffic, seed, device, workdir):
        from calibration_tpu_torch.optim import IntrinsicsOptimOptions, OptimOptions

        self.device = device
        self.fleets = int(traffic["fleets"])
        self.sensors = int(traffic["sensors"])
        shape = cfg["shapes"]
        solver = cfg["solver"]
        self.huber = float(solver["huber_delta"])
        self.opts = IntrinsicsOptimOptions(core=OptimOptions(
            max_iterations=int(solver["max_iterations"]), epsilon=float(solver["epsilon"]),
            huber_delta=self.huber, compute_covariance=bool(solver["compute_covariance"])))
        self.obj, self.uv = [], []
        for k in range(self.fleets):
            obj, uv, intr = gen.make_problems(self.sensors, shape["views"], shape["rows"], shape["cols"],
                                              shape["noise_px"], seed=program.fleet_seed(seed, k))
            self.obj.append(torch.as_tensor(obj, device=device))
            self.uv.append(torch.as_tensor(uv, device=device))
        self.truth_intr = torch.as_tensor(np.tile(intr, (self.sensors, 1)), device=device)
        self.truth_poses = torch.as_tensor(gen.bench_poses(self.sensors, shape["views"]), device=device)
        self.mask = torch.ones(self.obj[0].shape[:3], dtype=torch.float64, device=device)
        self.var_index = torch.as_tensor(planar.FREE_INTRINSICS, device=device)
        self._ref = {}

    def call(self, i):
        from calibration_tpu_torch.parallel import batched

        k = i % self.fleets
        _, _, out, rms = batched.intrinsics_facade_batch(self.obj[k], self.uv[k], opts=self.opts)
        lm, intr, poses, _, cov, _ = out
        return {"fleet": k, "success": lm.success, "linearizations": lm.linearizations, "intr": intr,
                "poses": poses, "var": cov.diagonal(dim1=-2, dim2=-1)[:, self.var_index], "rms": rms}

    def outcome(self, out):
        return self.sensors, int((~out["success"]).sum())

    def counters(self, kept):
        lin = torch.stack([out["linearizations"] for out in kept]).double()
        return {"schur.linearizations": float(lin.mean())}

    def reference(self, k, dtype=torch.float64):
        """(camera, poses, cost, variances) of fleet k, solved from the
        truth by the reference in ``dtype``."""
        intr, poses, cost = planar.solve(self.obj[k], self.uv[k], self.mask, self.truth_intr, self.truth_poses,
                                         self.huber, dtype=dtype)
        var = planar.intrinsic_variances(self.obj[k], self.uv[k], self.mask, intr, poses, self.huber, dtype=dtype)
        return intr, poses, cost, var

    def control(self, k):
        """Fleet k's outputs from the reference in the next precision down:
        the solve and covariance in float32, the QA RMS in bfloat16."""
        intr, poses, _, var = self.reference(k, torch.float32)
        rms = planar.view_rms(self.obj[k], self.uv[k], self.mask, intr, poses, dtype=torch.bfloat16)
        ok = torch.ones(self.sensors, dtype=torch.bool, device=self.device)
        return {"fleet": k, "success": ok, "linearizations": torch.zeros_like(ok, dtype=torch.int64),
                "intr": intr.double(), "poses": poses.double(), "var": var.double(), "rms": rms.float()}

    def judge(self, kept):
        cost_gap, cov_gap, qa_gap = [], [], []
        for out in kept:
            k = out["fleet"]
            if k not in self._ref:
                self._ref[k] = self.reference(k)
            _, _, ref_cost, ref_var = self._ref[k]
            obj, uv = self.obj[k], self.uv[k]
            cost = planar.cost(obj, uv, self.mask, out["intr"], out["poses"], self.huber)
            cost_gap.append(((cost - ref_cost).abs() / ref_cost).max())
            cov_gap.append(((out["var"] - ref_var).abs() / ref_var).max())
            rms = planar.view_rms(obj, uv, self.mask, out["intr"], out["poses"])
            qa_gap.append((out["rms"].double() - rms).abs().max())
        return {"cost_gap": program.worst(cost_gap), "cov_gap": program.worst(cov_gap),
                "qa_gap_px": program.worst(qa_gap)}
