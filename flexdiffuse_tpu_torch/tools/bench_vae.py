"""VAE decode cost at 512² and the mid-block attention at its shape.

Port of ``tools/bench_vae.py``. The SD VAE decoder's mid-block attention is
one 512-wide head over 4096 tokens (``models/vae.py``). The dispatcher
keeps heads wider than 128 off the flash kernels, as JAX's does, so the
decode runs it through the plain attention under either backend; a direct
call of ``flash_attention`` takes the Hopper wide kernel ('wide_sm90',
``csrc/flash_wide.cu``), the counterpart of JAX's streaming kernel K2 at
this shape. Measured: the raw ``(1,1,4096,512)`` bf16 op, 20 chained calls
through the wide kernel and through ``plain_attention`` (JAX's
``xla_attention``), the kernel's max error against fp32 attention, and the
whole 512² decode under backend 'plain' and 'flash'.

    python -m flexdiffuse_tpu_torch.tools.bench_vae [--device cpu]

Prints one JSON line. On the CPU (``--device cpu``) it runs the tiny VAE
and a small op through the plain versions, as a check that the path runs.
"""
from __future__ import annotations

import numpy as np
import torch

from flexdiffuse_tpu_torch.models import SD14_VAE, AutoencoderKL
from flexdiffuse_tpu_torch.models.configs import TINY_VAE
from flexdiffuse_tpu_torch.ops import attention as attn_mod
from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.tools import BF16, parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import (emit, finite, seeded,
                                                      timed)

OP_SHAPE = (1, 1, 4096, 512)
CALLS = 20


def raw_op(device: torch.device, shape=OP_SHAPE, calls: int = CALLS,
           reps: int = 3, seed: int = 0) -> dict:
    """``calls`` chained attention calls (``q ← attention(q, k, v)``) at
    ``shape`` in bf16, through ``flash_attention`` (the wide kernel on the
    card) and ``plain_attention``: ms per call, best of ``reps`` after a
    warm-up; and the kernel's max|Δ| to fp32 attention on the first q.
    ``flash_calls``: the ``flash_attention`` calls made."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(device).to(BF16) for _ in range(3))
    scale = shape[-1]**-0.5

    def chain(fn):
        def run():
            qc = q
            for _ in range(calls):
                qc = fn(qc, k, v, scale)
            return qc
        return run

    ref = fa.plain_attention(q.float(), k.float(), v.float(), scale)
    err = (fa.flash_attention(q, k, v, scale).float() - ref).abs().max()
    flash, out, _ = timed(chain(fa.flash_attention), device, reps)
    plain, _, _ = timed(chain(fa.plain_attention), device, reps)
    return dict(op_shape=list(shape), calls=calls,
                path=fa.plan(q, k, v).path if device.type == 'cuda'
                else 'plain', flash_maxerr_vs_fp32=float(err),
                mid_attn_flash_ms=min(flash) / calls * 1e3,
                mid_attn_plain_ms=min(plain) / calls * 1e3,
                chain_finite=finite(out),
                flash_calls=1 + calls * (reps + 1))


@torch.no_grad()
def decode(vae: AutoencoderKL, device: torch.device, side: int = 64,
           reps: int = 5, seed: int = 0) -> dict:
    """The decode of one ``side``² latent under each attention backend:
    ms (best of ``reps`` after a warm-up) and whether the image is
    finite."""
    rng = np.random.default_rng(seed)
    lat = torch.from_numpy(rng.normal(size=(1, side, side, 4)).astype(
        np.float32)).to(device)
    dtype = next(vae.parameters()).dtype
    res = {}
    for name in ('plain', 'flash'):
        with attn_mod.backend(name):
            times, out, _ = timed(lambda: vae.decode(lat.to(dtype)), device,
                                  reps)
        res[name] = dict(ms=min(times) * 1e3, finite=finite(out))
    return res


def measure(vae: AutoencoderKL, device: torch.device, side: int = 64,
            shape=OP_SHAPE, calls: int = CALLS, reps: int = 3,
            decode_reps: int = 5) -> dict:
    res = raw_op(device, shape, calls, reps)
    res['decode'] = decode(vae, device, side, decode_reps)
    res['metric'] = (f'VAE mid-block attention {tuple(shape)} and the '
                     f'{side * 8}² decode')
    return res


def main() -> None:
    args = parser(__doc__).parse_args()
    device = resolve_device(args.device)
    if device.type == 'cuda':
        vae = seeded(AutoencoderKL, SD14_VAE, device)
        res = measure(vae, device)
    else:
        vae = seeded(AutoencoderKL, TINY_VAE, device, torch.float32)
        res = measure(vae, device, side=8, shape=(1, 1, 256, 160), calls=2,
                      reps=1, decode_reps=1)
    emit(res, device)


if __name__ == '__main__':
    main()
