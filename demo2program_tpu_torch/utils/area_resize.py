"""Area-averaging downscale of uint8 images, bit for bit as OpenCV's
`cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)`.

The JAX package shrinks DoomLite's 160x120 frames to the dataset's 80x80
with cv2 (data/vizdoom_generator.py:downsize, eval/vizdoom_scorer.py); the
port does it with numpy alone, so a host without cv2 generates and scores
the same frames. Execution accuracy compares frames with `==`, so one pixel
off would turn a correct program into a wrong one: this follows OpenCV's
general area path (`computeResizeAreaTab` and `ResizeArea_Invoker` in
imgproc/resize.cpp) operation for operation.

  * Along each axis, destination index d covers source [d*scale,
    (d+1)*scale), scale = 1 / (dst / src) in double. Each source cell it
    touches gets the weight overlap / min(scale, src - d*scale), rounded to
    float32; partial overlaps under 1e-3 are dropped.
  * Per source row, the row's horizontal sums are accumulated in float32 in
    table order (0 + s0*a0 + s1*a1 + ...); per destination row, those row
    sums are accumulated in float32 weighted by the vertical weights, in
    table order.
  * The result is rounded half to even (cvRound) and saturated to [0, 255].

OpenCV takes another path, with integer sums, when both scales are
integers: it is not implemented here and raises. DoomLite's frames go
through the general path (their vertical scale is 1.5). Only downscales are
implemented, as INTER_AREA's true area path is only defined there.
"""

import math

import numpy as np


def _area_table(src, dst):
    """(src index (dst, E) int64, weight (dst, E) float32) of each
    destination index; rows padded with weight 0, which adds exactly 0."""
    scale = 1.0 / (dst / src)
    entries = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        for s in range(s1, s2):
            row.append((s, 1.0 / cell))
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        entries.append(row)
    width = max(len(r) for r in entries)
    index = np.zeros((dst, width), np.int64)
    weight = np.zeros((dst, width), np.float64)
    for d, row in enumerate(entries):
        for e, (s, a) in enumerate(row):
            index[d, e] = s
            weight[d, e] = a
    return index, weight.astype(np.float32)


_TABLES = {}


def _tables(src_hw, dst_hw):
    key = (src_hw, dst_hw)
    if key not in _TABLES:
        _TABLES[key] = (_area_table(src_hw[0], dst_hw[0]),
                        _area_table(src_hw[1], dst_hw[1]))
    return _TABLES[key]


def area_resize(img, dsize):
    """`cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)` for uint8
    images: img (..., H, W, C) -> (..., dsize[1], dsize[0], C). dsize is
    (width, height), as in cv2. Leading axes are a stack of images."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim < 3:
        raise TypeError(f"area_resize takes uint8 (..., H, W, C) images, "
                        f"not {img.dtype} {img.shape}")
    H, W = img.shape[-3], img.shape[-2]
    out_w, out_h = int(dsize[0]), int(dsize[1])
    if out_h > H or out_w > W:
        raise ValueError(f"area_resize only shrinks: ({H}, {W}) -> "
                         f"({out_h}, {out_w})")
    if H % out_h == 0 and W % out_w == 0:
        raise NotImplementedError(
            f"({H}, {W}) -> ({out_h}, {out_w}) has integer scales: OpenCV's "
            "integer area path is not implemented")
    (yi, yw), (xi, xw) = _tables((H, W), (out_h, out_w))
    src = img.astype(np.float32)
    # horizontal pass, per source row: buf[..., y, dx, c]
    buf = np.zeros(img.shape[:-2] + (out_w, img.shape[-1]), np.float32)
    for e in range(xi.shape[1]):
        buf = buf + src[..., xi[:, e], :] * xw[:, e][:, None]
    # vertical pass: sum[..., dy, dx, c]
    acc = buf[..., yi[:, 0], :, :] * yw[:, 0][:, None, None]
    for e in range(1, yi.shape[1]):
        acc = acc + buf[..., yi[:, e], :, :] * yw[:, e][:, None, None]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)
