"""Per-step lr and weight-decay annealing, as Python floats of the step.

Linear warmup from wp0 to 1 over wp_it steps, then one of {cos, lin, lin0,
lin00, linT, exp} decays to wpe; weight decay follows a half-cycle cosine
from wd to wd_end over the whole run. The train step computes both on the
host from its integer step count and writes them into the optimizer's
parameter groups.
"""
from __future__ import annotations

import math
from typing import Tuple


def lr_at_step(sche_type: str, step: int, peak_lr: float, wp_it: int, max_it: int,
               wp0: float = 0.005, wpe: float = 0.001) -> float:
    step = float(step)
    wp_it_f = float(round(wp_it))
    if step < wp_it_f:
        return peak_lr * (wp0 + (1 - wp0) * step / max(wp_it_f, 1.0))
    pasd = (step - wp_it_f) / max(max_it - 1 - wp_it_f, 1.0)
    rest = 1.0 - pasd
    if sche_type == "cos":
        frac = wpe + (1 - wpe) * (0.5 + 0.5 * math.cos(math.pi * pasd))
    elif sche_type in ("lin", "lin0"):
        T = 0.15 if sche_type == "lin" else 0.05
        frac = 1.0 if pasd < T else wpe + (1 - wpe) * rest / (1 - T)
    elif sche_type == "lin00":
        frac = wpe + (1 - wpe) * rest
    elif sche_type.startswith("lin"):
        T = float(sche_type[3:])
        max_rest = 1 - T
        wpe_mid = (1 + wpe + (1 - wpe) * max_rest) / 2
        frac = (1 + (wpe_mid - 1) * pasd / T if pasd < T
                else wpe + (wpe_mid - wpe) * rest / max_rest)
    elif sche_type == "exp":
        T = 0.15
        frac = 1.0 if pasd < T else math.exp((pasd - T) / (1 - T) * math.log(wpe))
    else:
        raise NotImplementedError(f"unknown sche_type {sche_type}")
    return peak_lr * frac


def wd_at_step(step: int, wd: float, wd_end: float, max_it: int) -> float:
    """Half-cycle cosine weight-decay anneal from wd to wd_end."""
    pasd = float(step) / max(max_it - 1, 1)
    return wd_end + (wd - wd_end) * (0.5 + 0.5 * math.cos(math.pi * pasd))


def lr_wd_at_step(sche_type: str, step: int, peak_lr: float, wd: float, wd_end: float,
                  wp_it: int, max_it: int, wp0: float = 0.005,
                  wpe: float = 0.001) -> Tuple[float, float]:
    return (lr_at_step(sche_type, step, peak_lr, wp_it, max_it, wp0, wpe),
            wd_at_step(step, wd, wd_end, max_it))
