"""Piecewise rational-quadratic spline transforms.

Counterpart of ``viet_tts_tpu/models/vits2/transforms.py`` (the neural
spline flow with linear tails): softmax bin widths and heights floored at
``min_bin_width`` / ``min_bin_height``, softplus knot derivatives floored at
``min_derivative``, the bin of each input found by counting the edges at or
below it (the last edge raised by 1e-6), the inverse as the root of the
bin's quadratic. Outside ``[-tail_bound, tail_bound]`` the transform is the
identity with log-determinant 0; the tails' knot derivatives are fixed so
that the spline meets them with slope 1.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations: torch.Tensor, inputs: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """The bin index of each input: the count of edges <= it, less one,
    with the last edge raised by ``eps``."""
    bin_locations = torch.cat([bin_locations[..., :-1], bin_locations[..., -1:] + eps], dim=-1)
    return (inputs[..., None] >= bin_locations).sum(dim=-1) - 1


def _knots(unnormalized: torch.Tensor, minimum: float, low: float,
           high: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(knot positions (..., K + 1) from ``low`` to ``high``, bin sizes
    (..., K)) of softmax bins floored at ``minimum``."""
    num_bins = unnormalized.shape[-1]
    sizes = minimum + (1.0 - minimum * num_bins) * torch.softmax(unnormalized, dim=-1)
    cum = (high - low) * F.pad(torch.cumsum(sizes, dim=-1), (1, 0)) + low
    edge = torch.full_like(cum[..., :1], low)
    cum = torch.cat([edge, cum[..., 1:-1], torch.full_like(edge, high)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def _log_derivative(delta, d0, d1, theta, theta_om, denominator):
    numerator = delta ** 2 * (d1 * theta ** 2 + 2.0 * delta * theta_om + d0 * (1.0 - theta) ** 2)
    return (torch.log(torch.clamp(numerator, min=1e-12))
            - 2.0 * torch.log(torch.clamp(denominator, min=1e-12)))


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs (...,) with per-element bins (..., K) and knot derivatives
    (..., K + 1) -> (outputs, log|d outputs / d inputs|)."""
    num_bins = unnormalized_widths.shape[-1]
    cumwidths, widths = _knots(unnormalized_widths, min_bin_width, left, right)
    cumheights, heights = _knots(unnormalized_heights, min_bin_height, bottom, top)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    bin_idx = torch.clamp(bin_idx, 0, num_bins - 1)[..., None]

    def gather(t):
        return torch.gather(t, -1, bin_idx)[..., 0]

    input_cumwidths = gather(cumwidths)
    input_bin_widths = gather(widths)
    input_cumheights = gather(cumheights)
    input_delta = gather(heights / widths)
    d0 = gather(derivatives)
    d1 = gather(derivatives[..., 1:])
    input_heights = gather(heights)
    slope_sum = d0 + d1 - 2.0 * input_delta

    if inverse:
        dy = inputs - input_cumheights
        a = dy * slope_sum + input_heights * (input_delta - d0)
        b = input_heights * d0 - dy * slope_sum
        c = -input_delta * dy
        discriminant = torch.clamp(b ** 2 - 4.0 * a * c, min=0.0)
        root = (2.0 * c) / (-b - torch.sqrt(discriminant) - 1e-12)
        outputs = root * input_bin_widths + input_cumwidths
        theta_om = root * (1.0 - root)
        denominator = input_delta + slope_sum * theta_om
        return outputs, -_log_derivative(input_delta, d0, d1, root, theta_om, denominator)

    theta = (inputs - input_cumwidths) / torch.clamp(input_bin_widths, min=1e-12)
    theta_om = theta * (1.0 - theta)
    numerator = input_heights * (input_delta * theta ** 2 + d0 * theta_om)
    denominator = input_delta + slope_sum * theta_om
    outputs = input_cumheights + numerator / torch.clamp(denominator, min=1e-12)
    return outputs, _log_derivative(input_delta, d0, d1, theta, theta_om, denominator)


def unconstrained_rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spline on ``[-tail_bound, tail_bound]``, the identity with
    log-determinant 0 outside it. ``unnormalized_derivatives`` holds the
    K - 1 inner knots' (..., K - 1)."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.expm1(1.0 - min_derivative))
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    spline_out, spline_logdet = rational_quadratic_spline(
        torch.clamp(inputs, -tail_bound, tail_bound), unnormalized_widths,
        unnormalized_heights, unnormalized_derivatives, inverse=inverse,
        left=-tail_bound, right=tail_bound, bottom=-tail_bound, top=tail_bound,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)
    outputs = torch.where(inside, spline_out, inputs)
    logabsdet = torch.where(inside, spline_logdet, torch.zeros_like(spline_logdet))
    return outputs, logabsdet
