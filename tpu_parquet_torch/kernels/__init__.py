"""NumPy host codecs for the parquet encodings.

Vectorized host implementations of the bit-packing, RLE/bit-packed hybrid,
PLAIN, DELTA and byte-array codecs: the writer encodes with them and the
device reader's page walk parses with them.  The device half of the decode
lives in ``torch_kernels`` and ``cuda_kernels``.
"""
