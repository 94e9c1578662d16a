"""The port's public solver and batch functions take their JAX twins'
parameters, by name and in order, so a call written for the reference
binds every argument to the same parameter in the port. Parameters only
the port has come after the reference's and are keyword-only. A value the
port does not honour yet (a model other than pinhole, a precision other
than "f64", a device mesh, an unknown ``jac_mode``) raises
``NotImplementedError`` ("not ported yet") before any work.

The port's ``*_device`` functions keep a leading batch axis where the
reference's take one problem: only names and order are compared."""

import inspect

import jax
import numpy as np
import pytest
import torch

from calibration_tpu.models.registry import SCHEIMPFLUG
from calibration_tpu.optim import bundle as jbundle
from calibration_tpu.optim import extrinsics as jext
from calibration_tpu.optim import handeye as jhe
from calibration_tpu.optim import homography as jhom
from calibration_tpu.optim import intrinsics as jintr
from calibration_tpu.optim import lm as jlm
from calibration_tpu.parallel import batched as jbatched
from calibration_tpu_torch.optim import bundle as tbundle
from calibration_tpu_torch.optim import extrinsics as text
from calibration_tpu_torch.optim import handeye as the
from calibration_tpu_torch.optim import homography as thom
from calibration_tpu_torch.optim import intrinsics as tintr
from calibration_tpu_torch.optim import lm as tlm
from calibration_tpu_torch.parallel import batched as tbatched

PAIRS = {
    "optimize_intrinsics_device": (tintr, jintr),
    "optimize_intrinsics": (tintr, jintr),
    "intrinsics_covariance_device": (tintr, jintr),
    "optimize_extrinsics_device": (text, jext),
    "optimize_extrinsics": (text, jext),
    "optimize_handeye_device": (the, jhe),
    "optimize_handeye": (the, jhe),
    "estimate_and_optimize_handeye": (the, jhe),
    "optimize_homography_device": (thom, jhom),
    "optimize_homography": (thom, jhom),
    "homography_covariance_device": (thom, jhom),
    "optimize_bundle_device": (tbundle, jbundle),
    "optimize_bundle": (tbundle, jbundle),
    "lm_core": (tlm, jlm),
    "covariance": (tlm, jlm),
    "intrinsics_batch": (tbatched, jbatched),
    "intrinsics_facade_batch": (tbatched, jbatched),
    "extrinsics_batch": (tbatched, jbatched),
    "homography_batch": (tbatched, jbatched),
    "handeye_batch": (tbatched, jbatched),
    "reprojection_rms_batch": (tbatched, jbatched),
    "bundle_batch": (tbatched, jbatched),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_matches_the_reference(name):
    port_mod, jax_mod = PAIRS[name]
    port = inspect.signature(getattr(port_mod, name)).parameters
    ref = inspect.signature(getattr(jax_mod, name)).parameters
    extra = [p for p in port.values() if p.name not in ref]
    assert all(p.kind is p.KEYWORD_ONLY for p in extra), f"port-only parameters must be keyword-only: {extra}"
    shared = [p for p in port.values() if p.name in ref]
    assert [p.name for p in shared] == list(ref), f"{name}: {list(port)} vs the reference's {list(ref)}"
    assert [p.kind for p in shared] == [p.kind for p in ref.values()], name


def test_the_reference_scheduler_name_is_not_reused():
    """The reference's phase_schedule(model_name, b, opts) has another
    contract than the port's iteration budget, which is private."""
    assert not hasattr(tbatched, "phase_schedule")
    assert tbatched._phase_budget(50, (5,)) == (5, 45)


def _z(*shape):
    return torch.zeros(shape, dtype=torch.float64)


def _intr_args(b=(1,)):
    return (_z(*b, 4, 6, 2), _z(*b, 4, 6, 2), _z(*b, 10), _z(*b, 4, 4, 4))


def _extr_args(b=(1,)):
    return (_z(*b, 3, 2, 6, 2), _z(*b, 3, 2, 6, 2), _z(*b, 2, 10), _z(*b, 2, 4, 4), _z(*b, 3, 4, 4))


def _bundle_args(b=(1,)):
    return (_z(*b, 3, 6, 2), _z(*b, 3, 6, 2), _z(*b, 3, 4, 4), torch.zeros(b + (3,), dtype=torch.long), _z(*b, 1, 10),
            _z(*b, 1, 4, 4), _z(*b, 4, 4))


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("b",))


SCHEIM = SCHEIMPFLUG.name
UNPORTED = {
    "intrinsics_device_model": (tintr.optimize_intrinsics_device, _intr_args, {"model": SCHEIMPFLUG}),
    "intrinsics_device_mixed": (tintr.optimize_intrinsics_device, _intr_args, {"precision": "mixed"}),
    "intrinsics_device_mixed_jac": (tintr.optimize_intrinsics_device, _intr_args, {"precision": "mixed_jac"}),
    "intrinsics_host_model": (tintr.optimize_intrinsics, lambda: _intr_args(()), {"model": SCHEIMPFLUG}),
    "intrinsics_host_mixed": (tintr.optimize_intrinsics, lambda: _intr_args(()), {"precision": "mixed"}),
    "intrinsics_covariance_model": (tintr.intrinsics_covariance_device, _intr_args, {"model": SCHEIMPFLUG}),
    "extrinsics_device_model": (text.optimize_extrinsics_device, _extr_args, {"model": SCHEIMPFLUG}),
    "extrinsics_device_jac_mode": (text.optimize_extrinsics_device, _extr_args, {"jac_mode": "blocked"}),
    "extrinsics_host_model": (text.optimize_extrinsics, lambda: _extr_args(()), {"model": SCHEIMPFLUG}),
    "bundle_device_model": (tbundle.optimize_bundle_device, _bundle_args, {"model": SCHEIMPFLUG}),
    "bundle_device_mixed": (tbundle.optimize_bundle_device, _bundle_args, {"precision": "mixed"}),
    "bundle_host_model": (tbundle.optimize_bundle, lambda: _bundle_args(()), {"model": SCHEIMPFLUG}),
    "intrinsics_batch_model": (tbatched.intrinsics_batch, lambda: _intr_args()[:2], {"model_name": SCHEIM}),
    "intrinsics_batch_mixed": (tbatched.intrinsics_batch, lambda: _intr_args()[:2], {"precision": "mixed"}),
    "intrinsics_batch_mesh": (tbatched.intrinsics_batch, lambda: _intr_args()[:2], {"mesh": _mesh()}),
    "facade_batch_model": (tbatched.intrinsics_facade_batch, lambda: _intr_args()[:2], {"model_name": SCHEIM}),
    "facade_batch_mixed": (tbatched.intrinsics_facade_batch, lambda: _intr_args()[:2], {"precision": "mixed"}),
    "facade_batch_mesh": (tbatched.intrinsics_facade_batch, lambda: _intr_args()[:2], {"mesh": _mesh()}),
    "extrinsics_batch_model": (tbatched.extrinsics_batch, _extr_args, {"model_name": SCHEIM}),
    "extrinsics_batch_mesh": (tbatched.extrinsics_batch, _extr_args, {"mesh": _mesh()}),
    "homography_batch_mesh": (tbatched.homography_batch, lambda: (_z(1, 6, 2), _z(1, 6, 2)), {"mesh": _mesh()}),
    "handeye_batch_mesh": (tbatched.handeye_batch, lambda: (_z(1, 3, 4, 4), _z(1, 3, 4, 4)), {"mesh": _mesh()}),
    "bundle_batch_mesh": (tbatched.bundle_batch, _bundle_args, {"mesh": _mesh()}),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_values_raise(case):
    fn, args, kwargs = UNPORTED[case]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        fn(*args(), **kwargs)


def test_honoured_reference_values_are_accepted():
    """The reference's own defaults, passed by keyword, change nothing:
    model PINHOLE (the spec or its name), precision "f64", mesh None, any
    analytic_jac (the analytic Jacobian equals jacfwd)."""
    from calibration_tpu.models.registry import PINHOLE

    obj = torch.tensor(np.random.default_rng(0).uniform(-1, 1, (2, 8, 2)))
    dst = obj * 1.1 + 0.2
    base = tbatched.homography_batch(obj, dst, two_phase=False)
    same = tbatched.homography_batch(obj, dst, mesh=None, two_phase=False)
    assert torch.equal(base[1], same[1])
    from calibration_tpu_torch.optim.core import check_ported

    for model in (PINHOLE, PINHOLE.name, "pinhole", tintr.PINHOLE):
        check_ported(model, "f64", None)
