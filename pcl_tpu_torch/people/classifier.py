"""HOG and linear-SVM person classifier (PCL's ``PersonClassifier`` and
``HOG``: Piotr Dollar's HOG variant), weight-compatible with PCL's trained
model file.

Counterpart of ``pcl_tpu/people/classifier.py``, which is host numpy: a
copy, so that a window's descriptor and confidence are the JAX package's bit
for bit. The descriptor layout is PCL's ([4 norms][9 orients][cell x][cell
y], borders cropped: 3,024 values at 64 x 128).
"""

from __future__ import annotations

import re


import numpy as np


def load_hog_svm(path: str) -> dict:
    """Parse PCL's trained-SVM file (window size, offset b, flat weight
    list)."""
    txt = open(path).read()
    wh = int(re.search(r"window_height:\s*(\d+)", txt).group(1))
    ww = int(re.search(r"window_width:\s*(\d+)", txt).group(1))
    b = float(re.search(r"b:\s*([-\d.eE+]+)", txt).group(1))
    wl = re.search(r"weights:\s*\[(.*?)\]", txt, re.S).group(1)
    weights = np.asarray([float(v) for v in wl.split(",")], np.float32)
    return {"window_height": wh, "window_width": ww, "b": b,
            "weights": weights}


def _grad1(I: np.ndarray, axis: int) -> np.ndarray:
    """Central differences (r=0.5) with one-sided borders (r=1) — the
    PCL's grad1 (hog.cpp:410+)."""
    G = np.empty_like(I)
    sl = [slice(None)] * I.ndim

    def at(i):
        s = list(sl)
        s[axis] = i
        return tuple(s)

    G[at(slice(1, -1))] = 0.5 * (I[at(slice(2, None))] - I[at(slice(0, -2))])
    G[at(0)] = I[at(1)] - I[at(0)]
    G[at(-1)] = I[at(-1)] - I[at(-2)]
    return G


def dollar_hog(img: np.ndarray, bin_size: int = 8, n_orients: int = 9,
               clip: float = 0.2) -> np.ndarray:
    """HOG descriptor of an [H, W, C] float image in PCL's exact
    layout (hog.cpp compute(): gradMag -> soft-binned gradHist ->
    4-normalization -> interior crop, flattening order
    [norm][orient][cell_x][cell_y])."""
    H, W = img.shape[:2]
    if img.ndim == 2:
        img = img[:, :, None]
    hb, wb = H // bin_size, W // bin_size
    # per-channel gradients; per-pixel winner channel by magnitude
    Gx = _grad1(img, 1)
    Gy = _grad1(img, 0)
    M2 = Gx * Gx + Gy * Gy
    cbest = np.argmax(M2, axis=2)
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    gx = Gx[ii, jj, cbest]
    gy = Gy[ii, jj, cbest]
    M = np.sqrt(M2[ii, jj, cbest])
    O = np.mod(np.arctan2(gy, gx), np.pi)          # [0, pi)

    # gradQuantize (hog.cpp:521): linear orientation interpolation,
    # magnitudes pre-scaled by 1/bin^2
    o = O * (n_orients / np.pi)
    o0 = np.floor(o).astype(np.int64)
    od = o - o0
    o0 = o0 % n_orients
    o1 = (o0 + 1) % n_orients
    norm = 1.0 / (bin_size * bin_size)
    M0 = M * (1 - od) * norm
    M1 = M * od * norm

    # soft spatial binning: bilinear over cell centers (hog.cpp:200-330)
    hist = np.zeros((n_orients, wb, hb), np.float64)
    xb = (np.arange(W) + 0.5) / bin_size - 0.5
    yb = (np.arange(H) + 0.5) / bin_size - 0.5
    xb0 = np.floor(xb).astype(np.int64)
    yb0 = np.floor(yb).astype(np.int64)
    xd = xb - xb0
    yd = yb - yb0
    # flat scatter over 4 spatial corners x 2 orientation bins
    for cx, wx_arr in ((xb0, 1 - xd), (xb0 + 1, xd)):
        for cy, wy_arr in ((yb0, 1 - yd), (yb0 + 1, yd)):
            CXb = np.broadcast_to(cx[None, :], (H, W))
            CYb = np.broadcast_to(cy[:, None], (H, W))
            WXb = np.broadcast_to(wx_arr[None, :], (H, W))
            WYb = np.broadcast_to(wy_arr[:, None], (H, W))
            okm = (CXb >= 0) & (CXb < wb) & (CYb >= 0) & (CYb < hb)
            wsp = WXb * WYb
            for ob, mm in ((o0, M0), (o1, M1)):
                flat = (ob * wb + np.clip(CXb, 0, wb - 1)) * hb \
                    + np.clip(CYb, 0, hb - 1)
                np.add.at(hist.reshape(-1), flat[okm].reshape(-1),
                          (mm * wsp)[okm].reshape(-1))

    # 4-way block normalization (hog.cpp:331-357)
    eps = 1e-4 / 4 / bin_size ** 4
    cellE = (hist ** 2).sum(axis=0)                 # [wb, hb]
    blockInv = np.zeros((wb, hb), np.float64)
    be = (cellE[:-1, :-1] + cellE[:-1, 1:] + cellE[1:, :-1] + cellE[1:, 1:])
    blockInv[:-1, :-1] = 1.0 / np.sqrt(be + eps)
    G = np.zeros((4, n_orients, wb, hb), np.float64)

    def apply(n, sx, sy):
        # G[n](x, y) = min(clip, H(o,x,y) * blockInv(x - sx, y - sy))
        xs = slice(sx, None)
        ys = slice(sy, None)
        xt = slice(0, wb - sx) if sx else slice(0, wb)
        yt = slice(0, hb - sy) if sy else slice(0, hb)
        G[n, :, xs, ys] = np.minimum(
            clip, hist[:, xs, ys] * blockInv[xt, yt][None])

    apply(0, 0, 0)
    apply(1, 0, 1)
    apply(2, 1, 0)
    apply(3, 1, 1)
    # interior crop, flatten [norm*orient][cell_x][cell_y] (hog.cpp:395-405)
    desc = G[:, :, 1:wb - 1, 1:hb - 1]
    return desc.reshape(4 * n_orients, wb - 2, hb - 2).reshape(-1).astype(np.float32)


def _resize_rgb(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Bilinear resize matching PCL's PersonClassifier::resize
    sampling (src = dst / scale, floor+fractional weights,
    person_classifier.hpp:109-175)."""
    H, W = img.shape[:2]
    s1 = out_h / H
    s2 = out_w / W
    yi = np.arange(out_h) / s1
    xi = np.arange(out_w) / s2
    f1 = np.clip(np.floor(yi).astype(np.int64), 0, H - 1)
    f2 = np.clip(np.floor(xi).astype(np.int64), 0, W - 1)
    c1 = np.clip(f1 + 1, 0, H - 1)
    c2 = np.clip(f2 + 1, 0, W - 1)
    w1 = (yi - f1)[:, None, None]
    w2 = (xi - f2)[None, :, None]
    g1 = img[f1][:, f2]
    g2 = img[c1][:, f2]
    g3 = img[f1][:, c2]
    g4 = img[c1][:, c2]
    return (g1 * (1 - w1) * (1 - w2) + g2 * w1 * (1 - w2)
            + g3 * (1 - w1) * w2 + g4 * w1 * w2)


class PersonClassifier:
    """evaluate(image, xc, yc, pixel_height) -> confidence, with the
    PCL's window geometry (impl/person_classifier.hpp:212-266:
    window = pixel_height / 0.75 tall, half as wide, black-padded crop,
    resized to 64x128, HOG dot weights minus offset)."""

    def __init__(self, model: dict):
        self.wh = model["window_height"]
        self.ww = model["window_width"]
        self.b = model["b"]
        self.weights = model["weights"]

    @classmethod
    def from_file(cls, path: str) -> "PersonClassifier":
        return cls(load_hog_svm(path))

    def evaluate(self, image: np.ndarray, xc: float, yc: float,
                 pixel_height: float) -> float:
        """``image``: [H, W, 3] float RGB in [0,1]; (xc, yc): window
        center in pixels; ``pixel_height``: person's projected height."""
        height = int(np.floor(pixel_height * self.wh / (0.75 * self.wh) + 0.5))
        width = int(np.floor(pixel_height * self.ww / (0.75 * self.wh) + 0.5))
        if height <= 0 or width <= 0:
            return float("nan")
        xmin = int(np.floor(xc - width / 2 + 0.5))
        ymin = int(np.floor(yc - height / 2 + 0.5))
        H, W = image.shape[:2]
        box = np.zeros((height, width, 3), np.float32)
        y0, y1 = max(ymin, 0), min(ymin + height, H)
        x0, x1 = max(xmin, 0), min(xmin + width, W)
        if y1 > y0 and x1 > x0:
            box[y0 - ymin:y1 - ymin, x0 - xmin:x1 - xmin] = image[y0:y1, x0:x1]
        sample = _resize_rgb(box, self.ww, self.wh).astype(np.float32)
        desc = dollar_hog(sample)
        return float(np.dot(self.weights, desc) - self.b)
