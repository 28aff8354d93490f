"""Text-to-image sampling as the published schedulers define it, with
classifier-free guidance: PNDM in PLMS mode (Liu et al. 2022, diffusers'
``PNDMScheduler`` with ``skip_prk_steps``) and deterministic DDIM (Song et
al. 2021) on ε or v (Salimans & Ho 2022) predictions. The training
schedule is SD's "scaled linear" betas; inference timesteps are spaced
"leading" with ``steps_offset``; the step past t = 0 lands on ᾱ₀
(``set_alpha_to_one=False``).

Config keys (group ``scheduler``): ``kind`` ('pndm' or 'ddim'),
``num_train_timesteps``, ``beta_start``, ``beta_end``, ``steps_offset``,
``prediction_type`` ('epsilon' or 'v_prediction').
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from bench_h100.reference import text, unet, vae
from bench_h100.reference.ops import Ops

Tensor = torch.Tensor


def alphas_cumprod(sc: dict) -> np.ndarray:
    n = sc['num_train_timesteps']
    betas = np.linspace(sc['beta_start']**0.5, sc['beta_end']**0.5, n,
                        dtype=np.float64)**2
    return np.cumprod(1.0 - betas)


def _transfer(acp, x: Tensor, t: int, prev_t: int, eps: Tensor) -> Tensor:
    """PNDM's x_t → x_prev (Liu et al. 2022, eq. 11)."""
    a_t = acp[t]
    a_p = acp[prev_t] if prev_t >= 0 else acp[0]
    coeff = math.sqrt(a_p / a_t)
    denom = a_t * math.sqrt(1.0 - a_p) + math.sqrt(a_t * (1.0 - a_t) * a_p)
    return coeff * x - ((a_p - a_t) / denom) * eps


def plms(model: Callable, x: Tensor, steps: int, sc: dict) -> Tensor:
    acp = alphas_cumprod(sc)
    ratio = sc['num_train_timesteps'] // steps
    base = np.arange(steps) * ratio + sc['steps_offset']
    ts = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
    ets, cur = [], None
    for counter, t in enumerate(int(v) for v in ts):
        e = model(x, t)
        prev_t = t - ratio
        if counter != 1:
            ets = ets[-3:] + [e]
        else:
            prev_t, t = t, t + ratio
        if len(ets) == 1 and counter == 0:
            mo, cur = e, x
        elif len(ets) == 1 and counter == 1:
            mo, x, cur = (e + ets[-1]) / 2, cur, None
        elif len(ets) == 2:
            mo = (3 * ets[-1] - ets[-2]) / 2
        elif len(ets) == 3:
            mo = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
        else:
            mo = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3] -
                  9 * ets[-4]) / 24
        x = _transfer(acp, x, t, prev_t, mo)
    return x


def ddim(model: Callable, x: Tensor, steps: int, sc: dict) -> Tensor:
    acp = alphas_cumprod(sc)
    ratio = sc['num_train_timesteps'] // steps
    v_pred = sc['prediction_type'] == 'v_prediction'
    for t in (np.arange(steps) * ratio)[::-1] + sc['steps_offset']:
        t = int(t)
        out = model(x, t)
        a_t = acp[t]
        a_p = acp[t - ratio] if t - ratio >= 0 else acp[0]
        if v_pred:
            x0 = math.sqrt(a_t) * x - math.sqrt(1.0 - a_t) * out
            eps = math.sqrt(a_t) * out + math.sqrt(1.0 - a_t) * x
        else:
            eps = out
            x0 = (x - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
        x = math.sqrt(a_p) * x0 + math.sqrt(1.0 - a_p) * eps
    return x


SAMPLERS = {'pndm': plms, 'ddim': ddim}


def generate(ops: Ops, cfg: dict, ids: Tensor, uncond_ids: Tensor,
             noise: Tensor, steps: int, scale: float) -> Tensor:
    """Images NHWC in ``[0, 1]`` for prompt rows ``ids`` ``[B, 77]`` under
    negative rows ``uncond_ids`` ``[B, 77]`` from unit noise ``[B, h, w,
    C]``: CFG ``u + scale·(c − u)`` on the model output at every step."""
    ctx = text.encode(ops, cfg['text'], torch.cat([uncond_ids, ids]))
    sc = cfg['scheduler']

    def model(x: Tensor, t: int) -> Tensor:
        tt = torch.full((2 * x.shape[0],), float(t), device=x.device)
        out = unet.forward(ops, cfg['unet'], torch.cat([x, x]), tt, ctx)
        u, c = out.chunk(2)
        return u + scale * (c - u)

    x = SAMPLERS[sc['kind']](model, noise.float(), steps, sc)
    return vae.decode(ops, cfg['vae'], x)
