"""Core layer of the PyTorch port: NHWC batching, borders, fixed point and
the kernel dispatch registry (twins of ``opencv_tpu/core``)."""
