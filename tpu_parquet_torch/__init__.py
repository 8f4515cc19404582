"""tpu_parquet_torch: the PyTorch/CUDA port of tpu-parquet.

Decodes Parquet straight into the memory of an NVIDIA GPU.  The host walks
footers, page headers and run headers; each row group's bytes are staged to
the card in one transfer, and the bulk transforms run there: the PyTorch
tensor code of ``torch_kernels`` and the hand-written CUDA kernels of
``cuda_kernels`` (``csrc/``).  The entry point is
:class:`tpu_parquet_torch.device_reader.DeviceFileReader`.

This package imports ``torch`` and numpy, never ``jax`` and nothing of the
``tpu_parquet`` package: the host modules it needs are its own copies.
"""

__version__ = "0.1.0"

from .footer import ParquetError, read_file_metadata

__all__ = ["ParquetError", "read_file_metadata", "__version__"]
