"""LDR-FLIP perceptual image difference (Andersson et al., HPG 2020):
a numpy copy of ``ngp_tpu/utils/flip.py`` (the same numbers).

The published metric — CSF-filtered YCxCz colour pipeline with
Hunt-adjusted HyAB distance and error redistribution, combined with
derivative-of-Gaussian edge/point feature differences — used wherever the
reference quotes FLIP numbers (the reference vendors NVIDIA's
implementation under scripts/flip/).

Layout: images are (H, W, 3) float in [0, 1]. All constants are the
published FLIP parameters. The CSF kernels are sums of two isotropic
Gaussians, applied separably (two 1-D passes per Gaussian) instead of a
dense 2-D convolution — identical result, O(r) instead of O(r^2) taps.
"""
from __future__ import annotations

import numpy as np

# sRGB -> XYZ (D65), the exact rational matrix the FLIP reference uses
_A_RGB2XYZ = np.array([
    [10135552 / 24577794, 8788810 / 24577794, 4435075 / 24577794],
    [2613072 / 12288897, 8788810 / 12288897, 887015 / 12288897],
    [1425312 / 73733382, 8788810 / 73733382, 70074185 / 73733382],
])
_A_XYZ2RGB = np.linalg.inv(_A_RGB2XYZ)
_WHITE = _A_RGB2XYZ @ np.ones(3)          # reference illuminant (D65)

# CSF Gaussian parameters (a1, b1, a2, b2) per opponent channel
_CSF = {
    "A": (1.0, 0.0047, 0.0, 1e-5),
    "RG": (1.0, 0.0053, 0.0, 1e-5),
    "BY": (34.1, 0.04, 13.5, 0.025),
}
_QC, _QF = 0.7, 0.5
_PC, _PT = 0.4, 0.95
_FEATURE_W = 0.082


def srgb_to_linear(c):
    c = np.asarray(c, np.float64)
    return np.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _linrgb_to_ycxcz(rgb):
    xyz = rgb @ _A_RGB2XYZ.T / _WHITE
    return np.stack([116 * xyz[..., 1] - 16,
                     500 * (xyz[..., 0] - xyz[..., 1]),
                     200 * (xyz[..., 1] - xyz[..., 2])], -1)


def _ycxcz_to_linrgb(ycc):
    y = (ycc[..., 0] + 16) / 116
    x = y + ycc[..., 1] / 500
    z = y - ycc[..., 2] / 200
    xyz = np.stack([x, y, z], -1) * _WHITE
    return xyz @ _A_XYZ2RGB.T


def _linrgb_to_lab(rgb):
    xyz = rgb @ _A_RGB2XYZ.T / _WHITE
    f = np.where(xyz > 0.00885, np.cbrt(np.maximum(xyz, 0)),
                 xyz / (3 * (6 / 29) ** 2) + 4 / 29)
    return np.stack([116 * f[..., 1] - 16,
                     500 * (f[..., 0] - f[..., 1]),
                     200 * (f[..., 1] - f[..., 2])], -1)


def _sep_gauss(img, sigma_px, radius):
    """Isotropic Gaussian blur exp(-d²/(2σ²)) via two 1-D passes with
    edge padding; kernel normalized jointly with its pair by the caller
    (returns the UNNORMALIZED separable filter response and its 2-D
    weight sum)."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma_px * sigma_px))
    pad = np.pad(img, ((radius, radius), (0, 0)), mode="edge")
    out = np.zeros_like(img)
    for i, w in enumerate(k):
        out += w * pad[i: i + img.shape[0]]
    pad = np.pad(out, ((0, 0), (radius, radius)), mode="edge")
    out2 = np.zeros_like(img)
    for i, w in enumerate(k):
        out2 += w * pad[:, i: i + img.shape[1]]
    return out2, float(k.sum()) ** 2


def _csf_filter(channel_img, ppd, channel):
    """CSF filtering: sum of two isotropic Gaussians parameterized in
    the frequency domain, a·sqrt(pi/b)·exp(-pi²·d²/b) with d in degrees
    — in pixel units a Gaussian with σ = ppd·sqrt(b/(2pi²))."""
    a1, b1, a2, b2 = _CSF[channel]
    bmax = max(max(b1, b2) for (_, b1, _, b2) in
               [v for v in _CSF.values()])
    radius = int(np.ceil(3 * np.sqrt(bmax / (2 * np.pi ** 2)) * ppd))
    total = None
    norm = 0.0
    for a, b in ((a1, b1), (a2, b2)):
        if a == 0.0:
            continue
        sigma = ppd * np.sqrt(b / (2 * np.pi ** 2))
        amp = a * np.sqrt(np.pi / b)
        resp, wsum = _sep_gauss(channel_img, sigma, radius)
        total = amp * resp if total is None else total + amp * resp
        norm += amp * wsum
    return total / norm


def _hunt(lab):
    out = lab.copy()
    out[..., 1] *= 0.01 * lab[..., 0]
    out[..., 2] *= 0.01 * lab[..., 0]
    return out


def _hyab(a, b):
    d = a - b
    return np.abs(d[..., 0]) + np.linalg.norm(d[..., 1:], axis=-1)


def _conv2(img, kern):
    r = kern.shape[0] // 2
    pad = np.pad(img, r, mode="edge")
    out = np.zeros_like(img)
    for i in range(kern.shape[0]):
        for j in range(kern.shape[1]):
            w = kern[i, j]
            if w != 0.0:
                out += w * pad[i: i + img.shape[0], j: j + img.shape[1]]
    return out


def _feature_kernels(ppd):
    sd = 0.5 * _FEATURE_W * ppd
    radius = int(np.ceil(3 * sd))
    x, y = np.meshgrid(np.arange(-radius, radius + 1),
                       np.arange(-radius, radius + 1))
    g = np.exp(-(x ** 2 + y ** 2) / (2 * sd * sd))
    kernels = {}
    for name, base in (("edge", -x * g), ("point", (x ** 2 / (sd * sd)
                                                    - 1) * g)):
        k = base.astype(np.float64)
        k = np.where(k < 0, k / (-k[k < 0].sum()), k / k[k > 0].sum())
        kernels[name] = k
    return kernels


def compute_flip_map(reference_srgb: np.ndarray, test_srgb: np.ndarray,
                     pixels_per_degree: float) -> np.ndarray:
    """Per-pixel LDR-FLIP error in [0, 1]; inputs (H, W, 3) sRGB."""
    ref = _linrgb_to_ycxcz(srgb_to_linear(reference_srgb[..., :3]))
    tst = _linrgb_to_ycxcz(srgb_to_linear(test_srgb[..., :3]))

    # --- color pipeline ---
    def filt(img):
        chans = [_csf_filter(img[..., c], pixels_per_degree, ch)
                 for c, ch in enumerate(("A", "RG", "BY"))]
        lin = _ycxcz_to_linrgb(np.stack(chans, -1))
        return np.clip(lin, 0.0, 1.0)

    pre_ref = _hunt(_linrgb_to_lab(filt(ref)))
    pre_tst = _hunt(_linrgb_to_lab(filt(tst)))
    de_hyab = _hyab(pre_ref, pre_tst)
    green = _hunt(_linrgb_to_lab(np.array([[[0.0, 1.0, 0.0]]])))
    blue = _hunt(_linrgb_to_lab(np.array([[[0.0, 0.0, 1.0]]])))
    cmax = float((_hyab(green, blue) ** _QC).item())
    p = de_hyab ** _QC
    pcc = _PC * cmax
    de_c = np.where(p < pcc, (_PT / pcc) * p,
                    _PT + ((p - pcc) / (cmax - pcc)) * (1.0 - _PT))

    # --- feature pipeline ---
    ry = (ref[..., 0] + 16) / 116
    ty = (tst[..., 0] + 16) / 116
    kerns = _feature_kernels(pixels_per_degree)
    de_f = np.zeros_like(ry)
    for name, k in kerns.items():
        fr = np.hypot(_conv2(ry, k), _conv2(ry, k.T))
        ft = np.hypot(_conv2(ty, k), _conv2(ty, k.T))
        de_f = np.maximum(de_f, np.abs(fr - ft))
    de_f = (de_f / np.sqrt(2)) ** _QF
    return de_c ** (1.0 - de_f)


def flip(test_srgb: np.ndarray, reference_srgb: np.ndarray,
         monitor_distance: float = 0.7, monitor_width: float = 0.7,
         monitor_resolution_x: int = 3840) -> float:
    """Mean LDR-FLIP under the standard viewing conditions (the
    reference's defaults: 0.7 m distance, 0.7 m wide 4K monitor)."""
    ppd = monitor_distance * (monitor_resolution_x / monitor_width) \
        * (np.pi / 180)
    return float(np.mean(compute_flip_map(reference_srgb, test_srgb, ppd)))
