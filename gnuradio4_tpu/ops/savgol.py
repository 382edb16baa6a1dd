"""Savitzky-Golay smoothing/derivative filter design
(≈ reference algorithm/filter/SavitzkyGolay.hpp).

Design is host-side float64 least-squares (the coefficients are just a pseudo-
inverse row); application is an ordinary FIR → rides the matrix units framing path.
"""

from __future__ import annotations

import numpy as np


def design_savgol(window: int, poly_order: int, *, deriv: int = 0,
                  delta: float = 1.0) -> np.ndarray:
    """FIR coefficients for S-G smoothing (deriv=0) or differentiation.

    ``window`` must be odd; returns taps h so that y = h ⊛ x estimates the
    deriv-th derivative of the poly_order fit at the window center.
    """
    if window % 2 != 1:
        raise ValueError("window must be odd")
    if poly_order >= window:
        raise ValueError("poly_order must be < window")
    if deriv > poly_order:
        raise ValueError("deriv must be ≤ poly_order")
    half = window // 2
    # Vandermonde of centered offsets; solve least squares e_deriv = A⁺ row
    t = np.arange(-half, half + 1, dtype=np.float64)
    a = np.vander(t, poly_order + 1, increasing=True)     # [window, order+1]
    # pinv row `deriv` gives the coefficient of t^deriv in the LS fit
    pinv = np.linalg.pinv(a)
    from math import factorial
    h = pinv[deriv] * (factorial(deriv) / (delta ** deriv))
    # convolution form: y[n] = Σ_k h[k]·x[n−k] — time-reverse the fit weights
    return h[::-1].copy()


def savgol_smooth(x: np.ndarray, window: int, poly_order: int) -> np.ndarray:
    """Host-side reference smoother (edge-truncated) for tests/UI."""
    h = design_savgol(window, poly_order)
    y = np.convolve(x, h[::-1], mode="same")
    return y


def savgol_dataset(ds, window: int, poly_order: int, *, deriv: int = 0,
                   delta: float = 1.0):
    """DataSet-domain Savitzky-Golay (≈ reference SavitzkyGolayDataSetFilter,
    blocks/filter/SavitzkyGolay registered GR_REGISTER_BLOCK site): smooth (or
    differentiate) EVERY signal of a captured DataSet, preserving axes, signal
    metadata, and timing events.

    DataSets live on the host here (captured trigger/poller windows — see
    StreamToDataSet / DataSink), so this is a host transform over the window,
    applied same-length (edge-truncated convolution like the reference's
    in-place DataSet processing)."""
    import dataclasses as _dc
    h = design_savgol(window, poly_order, deriv=deriv, delta=delta)
    vals = np.stack([np.convolve(sig, h[::-1], mode="same")
                     for sig in np.atleast_2d(ds.values)])
    out = _dc.replace(ds, values=vals.astype(ds.values.dtype)
                      if deriv == 0 else vals,
                      signals=[_dc.replace(s) for s in ds.signals])
    for i in range(out.n_signals):
        out.updated_range(i)
    return out
