"""The JAX package's tools, ported to the card.

The bench and A/B tools (``bench_vae``, ``bench_batch``, ``bench_train``,
``bench_serving``, ``bench_lcm``, ``deepcache_exp``, ``bench_deepcache``,
``cfg_interval_exp``, ``cmajor_exp``, ``tome_exp``, ``bench_sdxl``,
``sdxl_deepcache_exp``, ``sdxl_exp``, ``param_dtype_exp``,
``bench_tokenizer``; shared timing in
:mod:`.bench_common`) each mirror the script of the same name and print
its JSON keys. The parity harness is :mod:`.validate_reference` and
:mod:`.experiments`. The flash-kernel experiment tools below each mirror a
script in the repository's ``tools/`` and run the Hopper counterpart of
its Pallas kernel (``ops/flash_variants.py``):

* :mod:`.perf_experiment` — ``scan_time``, the 12-deep UNet chain every A/B
  below uses; baseline and conv-only UNet.
* :mod:`.flash_variants` — T6 (exp, exp2, exp2 with the 16-bit P's sum).
* :mod:`.flash_opt` — T1 (v0, vU, vG) and T2 (all heads in one block).
* :mod:`.flash_pipelined` — T3, and its UNet A/B against K1.
* :mod:`.flash_tt` — T4 ([B,H,D,S] operands), against K1 and in the UNet.
* :mod:`.flash_tt3` — T5 (exp2, the row sum folded into P·V, bf16 exp2).

Run one on the card with ``python -m flexdiffuse_tpu_torch.tools.<tool>``.
Every tool runs on the card unless the caller passes ``--device cpu``
(``device='cpu'``), and raises when there is no CUDA device and no
``--device cpu``. On the CPU a tool runs only its exactness part, at a
small shape, through the kernels' plain twins. Each takes an explicit
``torch.Generator``; from the command line it is seeded with 0, as the JAX
scripts use ``PRNGKey(0)``. Times are CUDA-event
times of data-dependent chains, best of 3 after a warm-up; every line says
which tile the kernel ran (the TPU block sizes are not carried over).
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional, Tuple

import torch

from flexdiffuse_tpu_torch.ops.flash_attention import plain_attention

BF16 = torch.bfloat16
TILE_NOTE = '64q x 64kv tile'


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``device`` or, when None, the card; raises when the card is asked for
    and there is none."""
    dev = torch.device(device or 'cuda')
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the tools run on the card; pass '
                           '--device cpu for the exactness part on the CPU')
    return dev


def parser(doc: Optional[str]) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=(doc or '').split('\n')[0])
    ap.add_argument('--device', default=None,
                    help="'cpu' runs the exactness part only (default: the "
                    'card)')
    return ap


def generator(device: torch.device) -> torch.Generator:
    return torch.Generator(device).manual_seed(0)


def randn(shape, gen: torch.Generator, dtype=BF16,
          scale: float = 1.0) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device)
    return (x * scale).to(dtype)


def qkv(shape, gen: torch.Generator, dtype=BF16):
    return tuple(randn(shape, gen, dtype) for _ in range(3))


def reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """fp32 attention of ``[B, H, S, D]`` inputs, one batch row at a time
    (the fp32 logits of (8,8,4096,40) would take 4 GB at once)."""
    return torch.cat([plain_attention(q[i:i + 1].float(), k[i:i + 1].float(),
                                      v[i:i + 1].float(), scale)
                      for i in range(q.shape[0])])


def transposed(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, S, D]`` ↔ ``[B, H, D, S]``, contiguous."""
    return x.transpose(-1, -2).contiguous()


def max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return (got.float() - ref).abs().max().item()


def tflops(shape, ms: float) -> float:
    """Useful TFLOP/s of one attention call: 4·B·H·S²·d operations."""
    b, h, s, d = shape
    return 4.0 * b * h * s * s * d / (ms * 1e-3) / 1e12


def chain_ms(step: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
             depth: int, repeats: int = 3) -> Tuple[float, torch.Tensor]:
    """ms per link of the data-dependent chain ``x ← step(x)``, ``depth``
    links long, by CUDA events: best of ``repeats`` after one warm-up; and
    the chain's end."""
    def run():
        x = x0
        for _ in range(depth):
            x = step(x)
        return x

    out = run()
    best = float('inf')
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / depth)
    return best, out
