"""Compute kernels: feature extraction, Hamming matching, image ops.

The reference implements these as per-pixel/per-keypoint C++ loops
(src/ORBextractor.cc, src/ORBmatcher.cc). Here every op is a dense, batched,
fixed-shape array program that XLA fuses and tiles for the device:

* fast.py      — FAST-9/16 segment test + corner score as dense map ops.
* pyramid.py   — image pyramid (bilinear, OpenCV-compatible geometry).
* orb.py       — intensity-centroid orientation, Gaussian blur, rBRIEF bits.
* extractor.py — full per-frame extraction with grid-uniform selection.
* hamming.py   — packed popcount + matmul Hamming distance.
* matching.py  — the masked-argmin matcher family (replaces all 11
                 ORBmatcher entry points).
"""
