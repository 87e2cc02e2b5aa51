"""imgproc ops of the PyTorch port (twins of ``opencv_tpu/ops``)."""
