"""OpenCV, imported on demand.

Only file I/O (TUM images, PNG dumps), visualization, the photometric
augmentation and the YAML settings reader use OpenCV. The SLAM system and
the synthetic renderer do not, so the main path runs without it.
"""
from __future__ import annotations


def require_cv2():
    """The cv2 module, or an ImportError that says what needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "this function needs OpenCV (pip install opencv-python); the "
            "SLAM system and the synthetic renderer do not") from e
    return cv2
