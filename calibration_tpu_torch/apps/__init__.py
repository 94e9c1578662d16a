"""CLI entry points of the port, the counterparts of ``calibration_tpu.apps``
(so far ``planar_intrinsics`` and ``intrinsic_extrinsic_pipeline``). Run as
``python -m calibration_tpu_torch.apps.<name>``.
"""
