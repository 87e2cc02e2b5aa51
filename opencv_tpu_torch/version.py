"""cv2.version — build metadata flags."""

opencv_version = "5.0.0-tpu"
contrib = False
headless = True
rolling = False
ci_build = False
