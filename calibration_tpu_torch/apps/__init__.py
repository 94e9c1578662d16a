"""CLI entry points of the port, the counterparts of ``calibration_tpu.apps``
(so far ``planar_intrinsics``). Run as
``python -m calibration_tpu_torch.apps.<name>``.
"""
