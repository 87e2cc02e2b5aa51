"""cv2.qt — Qt UI namespace (empty in headless builds, as in the wheel)."""
