"""calibration_tpu_torch — the PyTorch + CUDA port of ``calibration_tpu``.

The JAX package beside it is the reference: every module here keeps its
counterpart's name and layout (``models``, ``ops``, ``optim``,
``parallel``, ``io``, ``native``, ``pipeline``, ``utils``, ``apps``), and
the tests feed both the same problems. The JAX-free host modules (JSON
I/O, dataset, loaders, pipeline, reports) are copies, since the JAX
package cannot be imported without JAX. Differences in idiom:

- ``vmap`` over problems is a leading batch dimension written out;
- ``lax.while_loop`` is a Python loop over batched tensors with per-lane
  masks, ``lax.cond`` a host decision;
- every function works on the device and dtype of the tensors it is given.
  Nothing sets a global default dtype; the solvers run in float64, or in
  the reference's mixed precisions on request, as the reference does;
- a device mesh (``parallel.make_mesh``) is a list of torch devices, each
  shard of a batch solved on its own host thread.

The one TPU kernel of the reference (``ops/pallas_kernels.py``) is a CUDA
kernel here (``csrc/projection_residuals.cu``), built with nvcc on first use
(``kernels/_build.py``). This package never imports JAX.
"""

__version__ = "0.1.0"
