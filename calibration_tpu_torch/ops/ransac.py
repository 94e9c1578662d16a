"""Batched RANSAC over many independent problems (port of
``calibration_tpu/ops/ransac.py``: ``RansacOptions``,
``calculate_iterations``, ``ransac``, ``ransac_homography`` and
``ransac_plane``).

The reference runs one RANSAC per problem as a ``lax.while_loop`` over
ROUNDS of ``round_size`` hypotheses (one batched fit and one batched scoring
pass per round, best model by inlier count, then lower inlier RMS), and
``vmap`` lifts it over problems. Here every tensor carries a leading LANE
axis, one lane per problem, and the round loop runs on the host:

- Round 0 always runs. After each round a lane goes on only while its own
  adaptive bound (``calculate_iterations`` of its best inlier ratio) exceeds
  the hypotheses it has spent, as each vmapped lane of the reference keeps
  its state once its own ``cond`` is false. Later rounds run only the lanes
  still active (an index-select); the host reads whether any lane is active
  once per round.
- Sampling without replacement is the Gumbel top-k trick over the lane's
  valid data. A round's ``(round_size, N)`` noise comes from one function,
  ``round_noise``, seeded from ``(options.seed, round)`` and drawn on the
  CPU, and every lane shares it, as every vmapped view shares the
  reference's one key. So a lane's result does not depend on which lanes
  share its batch, nor on the device. Torch cannot
  reproduce JAX's threefry stream; the tests substitute JAX's draws for
  ``round_noise`` and then hold the port equal to JAX lane for lane.

Each round counts ``ransac.rounds.<device type>``
(``utils.profiling.counters()``), so a run can show that its prefilter ran
on the card, and runs in the span ``ransac.round``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..utils import profiling
from . import homography as H
from . import planefit


@dataclasses.dataclass(frozen=True)
class RansacOptions:
    """The reference's defaults (round_size is the batching grain: the
    hypotheses of one round)."""

    max_iters: int = 1000
    thresh: float = 2.0
    min_inliers: int = 12
    confidence: float = 0.99
    seed: int = 1234567
    refit_on_inliers: bool = True
    round_size: int = 128


def _integer_pow(x, n: int):
    """x**n by repeated squaring, the rounding order of JAX's integer_pow."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def calculate_iterations(confidence, inlier_ratio, min_samples, iters_so_far, max_iters):
    """The adaptive RANSAC bound: the smallest N with P(at least one
    all-inlier minimal sample in N draws) >= confidence, clamped to
    [iters_so_far, max_iters]; degenerate inputs (confidence <= 0,
    ratio <= 0, denominator >= 0) give max_iters. Elementwise over tensors;
    returns int32."""
    inlier_ratio = torch.as_tensor(inlier_ratio, dtype=torch.float64)
    f64 = dict(dtype=torch.float64, device=inlier_ratio.device)
    denom = torch.log(torch.clamp(1.0 - _integer_pow(inlier_ratio, min_samples), min=1e-12))
    bad = (inlier_ratio <= 0.0) | (denom >= 0.0) | (confidence <= 0.0)
    # log(1 - p) / denom, both negative for sane inputs
    num = torch.log(torch.clamp(torch.tensor(1.0 - confidence, **f64), min=1e-300))
    niter = torch.where(bad, float(max_iters), torch.ceil(num / denom))
    niter = torch.maximum(niter, torch.as_tensor(iters_so_far, **f64)).clamp(max=float(max_iters))
    return niter.to(torch.int32)


class RansacResult(NamedTuple):
    success: torch.Tensor  # (L,) bool
    model: torch.Tensor  # (L, ...)
    inlier_mask: torch.Tensor  # (L, N)
    inlier_count: torch.Tensor  # (L,)
    inlier_rms: torch.Tensor  # (L,)
    iters: torch.Tensor  # (L,) hypotheses evaluated, rounds run x round_size


def round_noise(seed: int, r: int, shape, device) -> torch.Tensor:
    """Standard Gumbel noise (float64, ``shape`` = (round_size, N)) for round
    ``r``, drawn on the CPU from a ``torch.Generator`` seeded from (seed, r)
    and moved to ``device``: the card and the CPU draw the same stream, so a
    lane's result does not depend on the device either. Every lane of a
    round shares it."""
    gen = torch.Generator()
    gen.manual_seed(((seed << 32) | r) & (2**63 - 1))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float64).tiny)))
    return g.to(device)


def _lane_gather(a, idx):
    """a (L, N, ...), idx (L, ...) -> a[l, idx[l, ...]]."""
    lanes = torch.arange(a.shape[0], device=a.device).reshape((-1,) + (1,) * (idx.ndim - 1))
    return a[lanes, idx]


def _scored(res, mask, options: RansacOptions):
    """Inliers (L, M, N), counts and inlier RMS (L, M) of residuals
    (L, M, N) against the lanes' masks (L, N)."""
    inl = (res <= options.thresh) & mask[:, None, :]
    counts = inl.sum(dim=-1)
    w = inl.to(res.dtype)
    rms = torch.sqrt(torch.sum(res * res * w, dim=-1) / torch.clamp(counts, min=1))
    return inl, counts, rms


def _run_round(r, data, mask, fit_fn, residual_fn, degenerate_fn, k_min, round_size, options):
    """One batched round over the given lanes: sample, fit and score
    ``round_size`` hypotheses per lane, return each lane's round-best
    (score, model, inliers, rms, count)."""
    lanes, n = mask.shape
    device = mask.device
    profiling.count(f"ransac.rounds.{device.type}")
    g = round_noise(options.seed, r, (round_size, n), device)
    logp = torch.where(mask, 0.0, -torch.inf).to(torch.float64)
    idx = torch.topk(g[None] + logp[:, None, :], k_min, dim=-1).indices  # (L, H, k)
    minimal = {key: _lane_gather(a, idx) for key, a in data.items()}

    models, fit_ok = fit_fn(minimal)
    if degenerate_fn is not None:
        fit_ok = fit_ok & ~degenerate_fn(minimal)
    # a hypothesis drawing an invalid datum is void (only possible when a
    # lane has fewer than k_min valid data)
    fit_ok = fit_ok & _lane_gather(mask, idx).all(dim=-1)

    res = residual_fn(models, data)  # (L, H, N)
    inl, counts, rms = _scored(res, mask, options)
    valid = fit_ok & (counts >= options.min_inliers)
    score = torch.where(
        valid,
        counts.to(res.dtype) * 1e9 - torch.minimum(rms, torch.tensor(1e8, dtype=rms.dtype, device=device)),
        -torch.inf,
    )
    b = torch.argmax(score, dim=-1)  # ties: the first index, as jnp.argmax
    lane = torch.arange(lanes, device=device)
    return score[lane, b], models[lane, b], inl[lane, b], rms[lane, b], counts[lane, b]


def ransac(
    data: dict,
    *,
    fit_fn: Callable,
    residual_fn: Callable,
    k_min_samples: int,
    options: RansacOptions = RansacOptions(),
    mask=None,
    degenerate_fn: Optional[Callable] = None,
    refit_fn: Optional[Callable] = None,
) -> RansacResult:
    """Estimator-driven RANSAC over L lanes at once.

    Args:
      data: dict of (L, N, ...) tensors; N is the datum axis.
      fit_fn: dict of minimal samples (L, H, k, ...) -> (models (L, H, ...),
        ok (L, H)).
      residual_fn: (models (L, M, ...), data) -> (L, M, N) residuals.
      k_min_samples: the minimal-sample size.
      mask: optional (L, N) datum validity.
      degenerate_fn: optional minimal samples -> (L, H) degeneracy flags.
      refit_fn: optional (data, inlier mask (L, N)) -> (models (L, ...),
        ok (L,)) for the final refit-on-inliers pass.
    """
    first = next(iter(data.values()))
    lanes, n = first.shape[0], first.shape[1]
    if mask is None:
        mask = torch.ones((lanes, n), dtype=torch.bool, device=first.device)
    mask = mask.bool()
    round_size = min(options.round_size, options.max_iters)
    num_rounds = -(-options.max_iters // round_size)  # ceil
    step = (fit_fn, residual_fn, degenerate_fn, k_min_samples, round_size, options)

    with profiling.span("ransac.round"):
        score, model, inl, rms, count = _run_round(0, data, mask, *step)
    rounds_done = torch.ones((lanes,), dtype=torch.int64, device=first.device)
    active = torch.ones((lanes,), dtype=torch.bool, device=first.device)
    n_valid = torch.clamp(mask.sum(dim=-1), min=1).to(torch.float64)
    for r in range(1, num_rounds):
        # a lane goes on while its own bound exceeds the hypotheses it spent
        spent = r * round_size
        dyn = calculate_iterations(
            options.confidence, count.to(torch.float64) / n_valid, k_min_samples, spent,
            options.max_iters,
        )
        active = active & (spent < dyn)
        with profiling.sync("ransac.active"):
            idx = torch.nonzero(active).squeeze(-1)
        if idx.numel() == 0:
            break
        with profiling.span("ransac.round"):
            s, m, i, q, c = _run_round(r, {k: a[idx] for k, a in data.items()}, mask[idx], *step)
        better = s > score[idx]  # strict: a tie keeps the earlier round's model
        upd = idx[better]
        score[upd], model[upd], inl[upd] = s[better], m[better], i[better]
        rms[upd], count[upd] = q[better], c[better]
        rounds_done[idx] += 1

    success = score > -torch.inf
    if options.refit_on_inliers and refit_fn is not None:
        re_model, re_ok = refit_fn(data, inl)
        re_inl, re_count, re_rms = (t[:, 0] for t in _scored(residual_fn(re_model[:, None], data), mask, options))
        use = re_ok & success
        model = torch.where(use.reshape((-1,) + (1,) * (model.ndim - 1)), re_model, model)
        inl = torch.where(use[:, None], re_inl, inl)
        rms = torch.where(use, re_rms, rms)
        count = torch.where(use, re_count, count)

    rms = torch.where(success, rms, torch.inf)
    return RansacResult(success, model, inl, count, rms, rounds_done * round_size)


def ransac_homography(obj_xy, img_uv, options: RansacOptions = RansacOptions(), mask=None):
    """The homography estimator under RANSAC, over L lanes: 4-point Hartley
    DLT fit, symmetric transfer residual (pixels and target units mixed, the
    reference's definition), collinearity degeneracy check, refit on all
    inliers. obj_xy/img_uv: (L, N, 2); mask: optional (L, N)."""

    def fit(d):
        h = H.estimate_homography_dlt(d["src"], d["dst"])
        return h, torch.isfinite(h).all(dim=-1).all(dim=-1)

    def resid(h, d):
        return H.symmetric_transfer_error(h, d["src"][:, None], d["dst"][:, None])

    def degen(d):
        return H.has_near_collinear_triplet(d["src"])

    def refit(d, inl):
        h = H.estimate_homography_dlt(d["src"], d["dst"], inl)
        return h, torch.isfinite(h).all(dim=-1).all(dim=-1) & (inl.sum(dim=-1) >= H.MIN_SAMPLES)

    return ransac(
        {"src": obj_xy, "dst": img_uv},
        fit_fn=fit,
        residual_fn=resid,
        k_min_samples=H.MIN_SAMPLES,
        options=options,
        mask=mask,
        degenerate_fn=degen,
        refit_fn=refit,
    )


def ransac_plane(pts, options: RansacOptions = RansacOptions(), mask=None):
    """The 3-point plane estimator under RANSAC, over L lanes: minimal
    3-point fit, point-plane distance residual, near-collinear degeneracy
    check, SVD refit on all inliers. pts: (L, N, 3); mask: optional
    (L, N)."""

    def fit(d):
        p = d["pts"]
        return planefit.fit_plane_3pt(p[..., 0, :], p[..., 1, :], p[..., 2, :])

    def resid(planes, d):
        return planefit.plane_point_distance(planes, d["pts"][:, None])

    def degen(d):
        p = d["pts"]
        return torch.linalg.norm(torch.linalg.cross(p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :]), dim=-1) < 1e-12

    def refit(d, inl):
        return planefit.fit_plane_svd(d["pts"], inl), inl.sum(dim=-1) >= 3

    return ransac(
        {"pts": pts},
        fit_fn=fit,
        residual_fn=resid,
        k_min_samples=3,
        options=options,
        mask=mask,
        degenerate_fn=degen,
        refit_fn=refit,
    )
